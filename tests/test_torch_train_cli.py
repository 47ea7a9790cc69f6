"""`videocof_torch.cli.train.main()` on the CPU: `factory.load_pipeline` is
monkeypatched to a tiny CPU pipeline (as `tests/test_torch_cli.py` drives
`fast_infer`), the data are cv2 clips named by a triplet JSON. Checked: the
flags and defaults equal JAX's CLI's, the checkpoint directory, the
exported LoRA file (read back by the port's reader) against JAX's
`lora_adapters_to_state_dict` on the same adapters (carried to JAX's layout
and back through `convert.lora_from_jax`), its merge by the port's
`merge_lora`, and the full fine-tuning export read back by the port's
reader."""

import copy
import json
import sys

import numpy as np
import pytest
import torch

from _tiny_train import tiny_models
from videocof_torch import convert, factory
from videocof_torch.cli import train as ptrain
from videocof_torch.models.lora import ADAPTER_TARGETS, merge_lora
from videocof_torch.models.weights import load_state_dict
from videocof_torch.pipeline import WanPipeline
from videocof_torch.utils import checkpoint
from videocof_torch.utils.checkpoint import export_dit_state_dict
from videocof_tpu.cli import train as jtrain
from videocof_tpu.models import lora as jlora

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def triplet_json(tmp_path_factory):
    root = tmp_path_factory.mktemp("clips")
    rng = np.random.default_rng(0)
    for name, hw in (("src", (24, 32)), ("ground", (24, 32)),
                     ("edit", (32, 24))):
        w = cv2.VideoWriter(str(root / f"{name}.mp4"),
                            cv2.VideoWriter_fourcc(*"mp4v"), 10, hw[::-1])
        for _ in range(12):
            w.write(rng.integers(0, 255, (*hw, 3), dtype=np.uint8))
        w.release()
    path = root / "train.json"
    path.write_text(json.dumps([
        {"original_video": "src.mp4", "grounded_video": "ground.mp4",
         "edited_video": "edit.mp4", "edit_instruction": "remove the box"},
        {"original_video": "edit.mp4", "grounded_video": "src.mp4",
         "edited_video": "src.mp4", "edit_instruction": "add a hat"}]))
    return str(path), str(root)


def _main(monkeypatch, pipe, argv):
    loads = []

    def load_pipeline(model_name, random_init=False, **kw):
        loads.append((model_name, random_init, kw))
        return pipe

    monkeypatch.setattr(factory, "load_pipeline", load_pipeline)
    trainer = ptrain.main(argv)
    assert loads == [("", True, {})]
    return trainer


def _argv(triplet_json, tmp_path, *extra):
    path, root = triplet_json
    return ["--train_json", path, "--data_root", root, "--random_init",
            "--height", "16", "--width", "16", "--source_frames", "5",
            "--target_frames", "5", "--reasoning_frames", "4",
            "--lr", "1e-3", *extra]


def _jax_layout(adapters):
    """The port's adapters as JAX's tree ({rank, alpha, blocks: {module:
    {name: {down [L, r, din], up [L, dout, r]}}}})."""
    return {"rank": adapters.rank, "alpha": adapters.alpha, "blocks": {
        mod: {name: {part: np.stack([getattr(b[mod][name], part).detach()
                                     .numpy() for b in adapters.blocks])
                     for part in ("down", "up")} for name in names}
        for mod, names in ADAPTER_TARGETS.items()}}


def test_flags_match_jax(monkeypatch, tmp_path):
    argv = ["--train_json", "t.json"]
    monkeypatch.setattr(sys, "argv", ["train", *argv])
    # the port's own flags of a multi-rank run beside JAX's
    own = {"dist_backend": "nccl", "offload_t5": False}
    assert vars(ptrain.parse_args(argv)) == {**vars(jtrain.parse_args()),
                                             **own}


def test_lora_training_cli(monkeypatch, tmp_path, triplet_json):
    dit, vae, t5 = tiny_models()
    base = copy.deepcopy(dit)
    pipe = WanPipeline(dit, vae, t5, device="cpu")
    ckpt, lora = tmp_path / "ckpt", tmp_path / "videocof.safetensors"
    trainer = _main(monkeypatch, pipe, _argv(
        triplet_json, tmp_path, "--lora_rank", "4", "--steps", "4",
        "--save_every", "2", "--checkpoint_dir", str(ckpt),
        "--export_lora", str(lora)))
    state = trainer.state
    assert state.step == 4 and np.isfinite(trainer.losses).all()
    assert checkpoint.checkpoint_steps(str(ckpt)) == [2, 4]
    for name, p in dit.state_dict().items():
        assert torch.equal(p, base.state_dict()[name]), name

    jad = _jax_layout(state.adapters)
    back = convert.lora_from_jax(jad, dit.cfg)
    for (n, p), (_, q) in zip(state.adapters.named_parameters(),
                              back.named_parameters()):
        assert torch.equal(p.detach(), q), n
    want = jlora.lora_adapters_to_state_dict(jad)
    got = load_state_dict(str(lora))
    assert set(got) == set(want)
    for key, arr in want.items():
        assert got[key].dtype == torch.float32, key
        np.testing.assert_array_equal(got[key].numpy(), arr, err_msg=key)

    merged = copy.deepcopy(base)
    names = merge_lora(merged, str(lora))
    assert len(names) == dit.cfg.num_layers * 10
    blk = state.adapters.blocks[1]["ffn"]["fc2"]
    delta = blk.up.detach() @ blk.down.detach()
    torch.testing.assert_close(
        merged.blocks[1].ffn.fc2.weight,
        base.blocks[1].ffn.fc2.weight + state.adapters.scale * delta,
        rtol=0, atol=1e-6)


def test_full_finetune_cli(monkeypatch, tmp_path, triplet_json):
    dit, vae, t5 = tiny_models(1)
    base = copy.deepcopy(dit)
    pipe = WanPipeline(dit, vae, t5, device="cpu")
    out = tmp_path / "dit.safetensors"
    trainer = _main(monkeypatch, pipe, _argv(
        triplet_json, tmp_path, "--steps", "2", "--batch_size", "2",
        "--export_safetensors", str(out)))
    assert trainer.state.step == 2 and trainer.state.params is dit
    assert not torch.equal(dit.blocks[0].ffn.fc1.weight,
                           base.blocks[0].ffn.fc1.weight)
    want = export_dit_state_dict(dit.state_dict(), dit.cfg)
    got = load_state_dict(str(out))
    assert set(got) == set(want)
    for key, t in want.items():
        assert torch.equal(got[key], t), key


def test_cli_stops_without_a_gpu(tmp_path, triplet_json):
    """The factory puts the models on CUDA: without one the CLI raises,
    it does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ptrain.main(_argv(triplet_json, tmp_path, "--steps", "1"))


def test_multi_rank_cli_stops_without_a_gpu(tmp_path, triplet_json,
                                            monkeypatch):
    """Under WORLD_SIZE > 1 the CLI takes the rank's device from
    `rank_device`: without CUDA it raises before any model is loaded, as
    at one rank, and does not train on the CPU."""
    def no_load(*a, **kw):
        raise AssertionError("a pipeline was loaded without a GPU")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(ptrain, "init_distributed", lambda **kw: None)
    monkeypatch.setattr(factory, "load_pipeline", no_load)
    with pytest.raises(RuntimeError, match="CUDA"):
        ptrain.main(_argv(triplet_json, tmp_path, "--steps", "1"))
