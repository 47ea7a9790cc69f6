"""Train-state checkpoints of the port (`utils.checkpoint.save_train_state`
and `restore_train_state`): LoRA and full fine-tuning states round-trip bit
for bit, one step from a restored state equals one from the state in memory
bit for bit, the trainer saves every ``save_every`` steps, and the latest
step is restored by default. JAX's save raises on its LoRA state (it reads
``state.params``) while the port's saves it: a stated departure."""

import copy
import os

import jax
import numpy as np
import optax
import pytest
import torch

from _tiny_train import TCFG, tiny_models, triplet, triplets
from videocof_torch.training import CoFTrainer, TrainerConfig
from videocof_torch.utils import checkpoint
from videocof_tpu.configs import WAN_TINY as J_WAN
from videocof_tpu.parallel import make_mesh
from videocof_tpu.training import train_step as jstep
from videocof_tpu.utils import checkpoint as jcheckpoint

torch.set_num_threads(1)


def _trainer(models, ckpt=None, lora=True, save_every=0):
    dit, vae, t5 = models
    tcfg = TrainerConfig(**dict(TCFG, save_every=save_every),
                         checkpoint_dir=ckpt, lora_rank=4 if lora else None)
    return CoFTrainer(dit, vae, t5, None, tcfg, device="cpu")


def _fresh(models, lora):
    """Models for a second trainer: the same frozen base for LoRA, a copy
    of the untrained DiT for full fine-tuning (whose state is the DiT)."""
    return models if lora else (copy.deepcopy(models[0]),) + models[1:]


def _state_tensors(state):
    """Every tensor of a train state, by name: the trained module's, the
    AdamW moments and step counts."""
    module = state.adapters if hasattr(state, "adapters") else state.params
    out = {f"module.{k}": v for k, v in module.state_dict().items()}
    for i, st in state.optimizer.adamw.state_dict()["state"].items():
        for key, val in st.items():
            out[f"adamw.{i}.{key}"] = val
    return out


def _assert_states_equal(got, want):
    assert got.step == want.step
    g, w = _state_tensors(got), _state_tensors(want)
    assert set(g) == set(w) and any(k.endswith("exp_avg_sq") for k in w)
    for key in w:
        assert g[key].dtype == w[key].dtype, key
        assert torch.equal(g[key], w[key]), key


@pytest.mark.parametrize("lora", [True, False], ids=["lora", "full"])
def test_train_state_round_trips_bit_for_bit(tmp_path, lora):
    models = tiny_models()
    init = copy.deepcopy(models[0])
    trainer = _trainer(models, str(tmp_path), lora, save_every=1)
    trainer.train(triplets(), total_steps=2)
    assert checkpoint.checkpoint_steps(str(tmp_path)) == [1, 2]
    fresh = _trainer(_fresh((init,) + models[1:], lora), lora=lora)
    state = checkpoint.restore_train_state(str(tmp_path), fresh.state)
    assert state is fresh.state
    _assert_states_equal(state, trainer.state)
    # plain tensors and dicts only: torch's safe loader reads the file
    payload = torch.load(os.path.join(tmp_path, "2", "train_state.pt"),
                         weights_only=True)
    assert set(payload) == {"step", "optimizer",
                            "adapters" if lora else "params"}


@pytest.mark.parametrize("lora", [True, False], ids=["lora", "full"])
def test_step_after_restore_is_bit_for_bit(tmp_path, lora):
    """A trainer restored at step 2 and the trainer that saved it take one
    more step on the same sample with the same seeded noise generator: the
    losses and the whole states are equal."""
    models = tiny_models(1)
    init = copy.deepcopy(models[0])
    trainer = _trainer(models, str(tmp_path), lora, save_every=2)
    trainer.train(triplets(), total_steps=2)
    fresh = _trainer(_fresh((init,) + models[1:], lora), lora=lora)
    checkpoint.restore_train_state(str(tmp_path), fresh.state)
    for t in (trainer, fresh):
        t.generator.manual_seed(1234)
        t.train(iter([triplet(99)]), total_steps=1)
    assert fresh.losses[-1] == trainer.losses[-1]
    assert fresh.state.step == trainer.state.step == 3
    _assert_states_equal(fresh.state, trainer.state)


def test_trainer_saves_every_save_every(tmp_path, capsys):
    """(step + 1) % save_every == 0, as JAX's trainer, with its log line;
    a restored state counts on from its step."""
    models = tiny_models()
    trainer = _trainer(models, str(tmp_path), save_every=2)
    trainer.train(triplets(), total_steps=5)
    assert checkpoint.checkpoint_steps(str(tmp_path)) == [2, 4]
    err = capsys.readouterr().err
    assert "[train] checkpoint @ step 2" in err
    assert "[train] checkpoint @ step 4" in err
    assert "@ step 5" not in err
    resumed = _trainer(models, str(tmp_path), save_every=2)
    checkpoint.restore_train_state(str(tmp_path), resumed.state, step=2)
    resumed.train(triplets(), total_steps=2)
    assert checkpoint.checkpoint_steps(str(tmp_path)) == [2, 4]
    assert resumed.state.step == 4


def test_restore_takes_the_latest_step_by_default(tmp_path):
    models = tiny_models()
    trainer = _trainer(models, str(tmp_path), save_every=1)
    trainer.train(triplets(), total_steps=3)
    snapshot = {k: v.clone() for k, v in
                _state_tensors(trainer.state).items()}
    trainer.train(triplets(), total_steps=1)     # step 4, saved
    os.makedirs(tmp_path / "9.partial")          # an interrupted save
    fresh = _trainer(models)
    assert checkpoint.restore_train_state(str(tmp_path),
                                          fresh.state).step == 4
    _assert_states_equal(fresh.state, trainer.state)
    checkpoint.restore_train_state(str(tmp_path), fresh.state, step=3)
    assert fresh.state.step == 3
    got = _state_tensors(fresh.state)
    assert all(torch.equal(got[k], v) for k, v in snapshot.items())
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_train_state(str(tmp_path / "none"), fresh.state)
    with pytest.raises(ValueError, match="params"):   # a LoRA checkpoint
        full = _trainer(_fresh(models, lora=False), lora=False)
        checkpoint.restore_train_state(str(tmp_path), full.state)


def test_lora_state_saves_where_jax_raises(tmp_path):
    """JAX's `save_train_state` reads ``state.params``, which its
    `LoRATrainState` lacks; the port saves its LoRA state."""
    init_fn, _ = jstep.make_lora_train_step(
        make_mesh(data=1, seq=1), J_WAN, optax.adamw(1e-4), rank=2,
        use_ulysses=False)
    jstate = init_fn(jax.random.PRNGKey(0))
    with pytest.raises(AttributeError, match="params"):
        jcheckpoint.save_train_state(str(tmp_path / "jax"), jstate)
    trainer = _trainer(tiny_models())
    path = checkpoint.save_train_state(str(tmp_path / "port"), trainer.state)
    assert path == str(tmp_path / "port" / "0")
    assert checkpoint.checkpoint_steps(str(tmp_path / "port")) == [0]
    np.testing.assert_equal(checkpoint.restore_train_state(
        str(tmp_path / "port"), trainer.state).step, 0)
