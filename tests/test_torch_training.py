"""The port's training path against the JAX package's: timestep bands, the
chain-of-frames flow-matching loss and its adapter gradients through the
flash attention (Pallas in interpret mode on the JAX side, the Function's
plain versions on the port's), whole LoRA and full fine-tuning steps, the
clip + AdamW optimizer against optax, the trainer's batch preparation, and a
tiny trainer run on the CPU. Weights are carried by `videocof_torch.convert`;
inputs and noise are numpy or JAX arrays handed to both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from videocof_tpu.configs import T5_TINY as J_T5, VAE_TINY as J_VAE
from videocof_tpu.configs import WAN_TINY as J_WAN
from videocof_tpu.data.tokenizer import WanTokenizer as JTokenizer
from videocof_tpu.models import lora as jlora
from videocof_tpu.models import t5_encoder as jt5, wan_dit as jdit
from videocof_tpu.models import wan_vae as jvae
from videocof_tpu.ops import flash_attention as jfa
from videocof_tpu.parallel import make_mesh
from videocof_tpu.training import timestep_sampler as jts
from videocof_tpu.training import train_step as jstep
from videocof_tpu.training.trainer import (CoFTrainer as JTrainer,
                                           TrainerConfig as JTrainerConfig)
from videocof_torch import convert
from videocof_torch.configs import T5Config, WanDiTConfig, WanVAEConfig
from videocof_torch.models.lora import LoRAAdapters
from videocof_torch.models.t5_encoder import T5Encoder
from videocof_torch.models.wan_dit import WanDiT
from videocof_torch.models.wan_vae import WanVAE
from videocof_torch.training import (ClipAdamW, CoFTrainer, DiscreteSampling,
                                     TrainerConfig, adamw, flow_matching_loss,
                                     make_lora_train_step, make_train_step)

torch.set_num_threads(1)

# head_dim 64, so JAX's flash attention takes the Pallas kernel (at head_dim
# 24 it raises and the dispatcher drops to XLA)
J_HD64 = J_WAN.replace(dim=128, ffn_dim=256, num_heads=2, num_layers=2)
J_TRAIN = J_WAN.replace(in_dim=J_VAE.z_dim, out_dim=J_VAE.z_dim,
                        text_dim=J_T5.dim)
as_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731


def _dit(jcfg, seed=0):
    params = jdit.init_wan_dit(jax.random.PRNGKey(seed), jcfg)
    dit = WanDiT(convert.config_from(WanDiTConfig, jcfg))
    dit.load_state_dict(convert.dit_from_jax(as_np(params)))
    return params, dit


def _batch(jcfg, seed=0, F=5, f_src=2):
    """x0 [1, C, F, 4, 4], context, CoF rope, a timestep, the frame mask."""
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((1, jcfg.in_dim, F, 4, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, jcfg.text_len, jcfg.text_dim)
                              ).astype(np.float32)
    cos, sin = jdit.make_rope_for_geometry(jcfg, (F, 2, 2), f_src=f_src,
                                           f_ground=1)
    mask = np.ones(F, np.float32)
    mask[:f_src] = 0.0
    return {"x0": x0, "context": ctx, "rope_cos": np.asarray(cos),
            "rope_sin": np.asarray(sin),
            "timesteps": np.array([700], np.int32), "frame_mask": mask}


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch_batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _spy_backward(monkeypatch):
    calls = []
    real = jfa._flash_bwd_bnld

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(jfa, "_flash_bwd_bnld", spy)
    return calls


def _jax_adapters(jcfg, seed=1, rank=4):
    """JAX adapters with a non-zero ``up`` (so down gets gradients too)."""
    ad = jlora.init_lora_adapters(jax.random.PRNGKey(seed), jcfg, rank=rank)
    rng = np.random.default_rng(seed)
    ad["blocks"] = jax.tree.map(
        lambda x: x + jnp.asarray(0.05 * rng.standard_normal(x.shape),
                                  x.dtype), ad["blocks"])
    return ad


def _adapter_leaves(ad: LoRAAdapters, jblocks, attr=None):
    """(port tensor, JAX array) pairs of every adapter, layer by layer."""
    for mod, names in jblocks.items():
        for name, a in names.items():
            for part in ("down", "up"):
                for i, block in enumerate(ad.blocks):
                    t = getattr(block[mod][name], part)
                    yield (t if attr is None else getattr(t, attr)), a[part][i]


# --------------------------------------------------------------------- sampler

@pytest.mark.parametrize("group_num,dp_rank,uniform", [
    (1, 0, True), (4, 1, True), (4, 3, True), (3, 5, True), (4, 2, False)])
def test_timestep_bands_match_jax(group_num, dp_rank, uniform):
    """Both samplers draw from the same band (their bits differ)."""
    js = jts.DiscreteSampling(group_num, uniform_sampling=uniform)
    ps = DiscreteSampling(group_num, uniform_sampling=uniform)
    assert ps.group_index(dp_rank) == js.group_index(dp_rank)
    want = np.asarray(js.sample(jax.random.PRNGKey(0), 4000, dp_rank=dp_rank))
    got = ps.sample(torch.Generator().manual_seed(0), 4000,
                    dp_rank=dp_rank).numpy()
    lo, hi = ps.bounds(dp_rank)
    assert (want.min(), want.max() + 1) == (lo, hi)
    assert (got.min(), got.max() + 1) == (lo, hi)
    assert got.shape == (4000,)


# ------------------------------------------------------------ loss and grads

def test_loss_and_adapter_grads_match_jax(monkeypatch):
    """flow_matching_loss with the CoF frame mask, remat and LoRA on both
    sides; the attention goes through the Pallas kernels on the JAX side
    (the spy counts its backward) and through the autograd Function on the
    port's."""
    monkeypatch.setenv("VIDEOCOF_ATTENTION_TYPE", "pallas")
    calls = _spy_backward(monkeypatch)
    params, dit = _dit(J_HD64)
    jad = _jax_adapters(J_HD64)
    ad = convert.lora_from_jax(jad, dit.cfg)
    b = _batch(J_HD64)
    noise = np.random.default_rng(9).standard_normal(b["x0"].shape
                                                     ).astype(np.float32)
    jb = _jax_batch(b)
    scale = jad["alpha"] / jad["rank"]

    def jloss(blocks):
        return jstep.flow_matching_loss(
            params, J_HD64, jb["x0"], jb["context"], jb["rope_cos"],
            jb["rope_sin"], jb["timesteps"], jnp.asarray(noise), remat=True,
            frame_mask=jb["frame_mask"], lora=(blocks, scale))

    want_loss, want_g = jax.value_and_grad(jloss)(jad["blocks"])
    assert calls, "the JAX side did not reach the Pallas backward"

    tb = _torch_batch(b)
    dit.requires_grad_(False)
    loss = flow_matching_loss(
        dit, tb["x0"], tb["context"], tb["rope_cos"], tb["rope_sin"],
        tb["timesteps"], torch.from_numpy(noise), attn_backend="flash",
        remat=True, frame_mask=tb["frame_mask"], lora=(ad, scale))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    pairs = list(_adapter_leaves(ad, want_g, "grad"))
    gmax = max(float(np.abs(np.asarray(w)).max()) for _, w in pairs)
    for t, w in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=2e-3,
                                   atol=2e-4 * gmax)


def test_frame_mask_keeps_source_clean():
    """The loss ignores the noise on source frames (tests/test_trainer.py's
    check, on the port)."""
    _, dit = _dit(J_TRAIN)
    tb = _torch_batch(_batch(J_TRAIN, F=7, f_src=3))
    noise = torch.randn(tb["x0"].shape, generator=torch.Generator()
                        .manual_seed(0))
    noise2 = noise.clone()
    noise2[:, :, :3] = 0.0
    with torch.no_grad():
        l1, l2 = (flow_matching_loss(dit, tb["x0"], tb["context"],
                                     tb["rope_cos"], tb["rope_sin"],
                                     tb["timesteps"], n, remat=False,
                                     frame_mask=tb["frame_mask"])
                  for n in (noise, noise2))
    torch.testing.assert_close(l1, l2, rtol=1e-6, atol=0)


# --------------------------------------------------------------------- steps

def _tx(lr):
    return optax.chain(optax.clip_by_global_norm(0.05),
                       optax.adamw(lr, weight_decay=1e-3))


def test_lora_step_matches_jax(monkeypatch):
    """One whole `make_lora_train_step` step: the same adapters, timesteps
    and noise (JAX draws it inside its step from the key; the test draws the
    same array and hands it to the port), the same clip + AdamW."""
    monkeypatch.setenv("VIDEOCOF_ATTENTION_TYPE", "pallas")
    lr = 1e-3
    params, dit = _dit(J_HD64)
    init_fn, step_fn = jstep.make_lora_train_step(
        make_mesh(data=1, seq=1), J_HD64, _tx(lr), rank=4, use_ulysses=False)
    state = init_fn(jax.random.PRNGKey(4))
    ad0 = as_np(state.adapters)
    b = _batch(J_HD64, seed=1)
    key = jax.random.PRNGKey(7)
    noise = np.array(jax.random.normal(key, b["x0"].shape, jnp.float32))
    calls = _spy_backward(monkeypatch)
    state2, want_loss = step_fn(state, params, _jax_batch(b), key)
    assert calls, "the JAX side did not reach the Pallas backward"
    want = as_np(state2.adapters["blocks"])

    pinit, pstep = make_lora_train_step(dit, adamw(lr, 1e-3, 0.05), rank=4,
                                        attn_backend="flash")
    pstate = pinit(adapters=convert.lora_from_jax(ad0, dit.cfg))
    pstate, loss = pstep(pstate, _torch_batch(b), noise=torch.from_numpy(noise))
    assert pstate.step == 1
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    moved = 0.0
    for (t, w), (_, w0) in zip(_adapter_leaves(pstate.adapters, want),
                               _adapter_leaves(pstate.adapters, ad0["blocks"])):
        # AdamW's first step moves each entry by about lr: compare the moves
        np.testing.assert_allclose(t.detach().numpy() - w0, w - w0, rtol=0,
                                   atol=1e-2 * lr)
        moved = max(moved, float(np.abs(w - w0).max()))
    assert moved > 0.5 * lr
    assert all(not p.requires_grad for p in dit.parameters())


def test_full_finetune_step_matches_jax():
    """One whole `make_train_step` step (every parameter trained)."""
    lr = 1e-4
    params, dit = _dit(J_TRAIN)
    init_fn, step_fn = jstep.make_train_step(
        make_mesh(data=1, seq=1), J_TRAIN, _tx(lr), use_ulysses=False)
    state = init_fn(params)
    b = _batch(J_TRAIN, seed=2)
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(key, b["x0"].shape, jnp.float32))
    state2, want_loss = step_fn(state, _jax_batch(b), key)
    want = convert.dit_from_jax(as_np(state2.params))
    before = {k: v.clone() for k, v in dit.state_dict().items()}

    pinit, pstep = make_train_step(dit, adamw(lr, 1e-3, 0.05))
    pstate, loss = pstep(pinit(), _torch_batch(b),
                         noise=torch.from_numpy(noise))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for name, p in pstate.params.state_dict().items():
        np.testing.assert_allclose((p - before[name]).numpy(),
                                   (want[name] - before[name]).numpy(),
                                   rtol=0, atol=2e-2 * lr, err_msg=name)


def test_clip_adamw_matches_optax():
    """Three updates of optax.chain(clip_by_global_norm, adamw): the clip
    acts in steps 1 and 3 and not in step 2."""
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(1e-2, weight_decay=1e-2))
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = ClipAdamW(tp, lr=1e-2, weight_decay=1e-2, max_norm=1.0)
    for step, gscale in enumerate((3.0, 0.05, 10.0)):
        grads = [gscale * rng.standard_normal(s).astype(np.float32)
                 for s in shapes]
        norm = np.sqrt(sum((g ** 2).sum() for g in grads))
        assert (norm >= 1.0) == (step != 1)
        updates, opt_state = tx.update([jnp.asarray(g) for g in grads],
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        assert all(p.grad is None for p in tp)
        for p, w in zip(tp, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------------- trainer

def _samples(seed=0, T=(5, 4, 5), hw=16):
    rng = np.random.default_rng(seed)
    while True:
        yield {
            "pixel_src": rng.uniform(-1, 1, (3, T[0], hw, hw)).astype(
                np.float32),
            "pixel_ground": rng.uniform(-1, 1, (3, T[1], hw, hw)).astype(
                np.float32),
            "pixel_tgt": rng.uniform(-1, 1, (3, T[2], hw, hw)).astype(
                np.float32),
            "text": "remove the cube",
        }


def _trainer_pair(tcfg_kw):
    dp = jdit.init_wan_dit(jax.random.PRNGKey(0), J_TRAIN)
    vp = jvae.init_wan_vae(jax.random.PRNGKey(1), J_VAE)
    tp = jt5.init_t5_encoder(jax.random.PRNGKey(2), J_T5)
    jtrainer = JTrainer(dp, J_TRAIN, vp, J_VAE, tp, J_T5,
                        JTokenizer(vocab_size=J_T5.vocab),
                        JTrainerConfig(**tcfg_kw))
    dit = WanDiT(convert.config_from(WanDiTConfig, J_TRAIN))
    dit.load_state_dict(convert.dit_from_jax(as_np(dp)))
    vae = WanVAE(convert.config_from(WanVAEConfig, J_VAE))
    vae.load_state_dict(convert.vae_from_jax(as_np(vp)))
    t5 = T5Encoder(convert.config_from(T5Config, J_T5))
    t5.load_state_dict(convert.t5_from_jax(as_np(tp)))
    return jtrainer, (dit, vae, t5)


TINY_TCFG = dict(height=16, width=16, source_frames=5, target_frames=5,
                 reasoning_frames=4, batch_size=1, log_every=1, save_every=0)


def test_prepare_batch_matches_jax():
    jtrainer, (dit, vae, t5) = _trainer_pair(TINY_TCFG)
    trainer = CoFTrainer(dit, vae, t5, None, TrainerConfig(**TINY_TCFG),
                         device="cpu")
    assert (trainer.f_src, trainer.f_ground, trainer.f_tgt) == (2, 1, 2)
    samples = [next(_samples())]
    want = jtrainer.prepare_batch(samples)
    got = trainer.prepare_batch(samples)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-5, err_msg=key)


def test_trainer_runs_on_cpu():
    """A tiny LoRA run: finite losses, moved adapters, the base untouched,
    the stage walls; full fine-tuning moves the base."""
    _, (dit, vae, t5) = _trainer_pair(TINY_TCFG)
    base = {k: v.clone() for k, v in dit.state_dict().items()}
    trainer = CoFTrainer(dit, vae, t5, None,
                         TrainerConfig(**TINY_TCFG, learning_rate=1e-3,
                                       lora_rank=4), device="cpu")
    timings = []
    state = trainer.train(_samples(), total_steps=2, timings=timings)
    assert state.step == 2 and len(trainer.losses) == 2
    assert np.isfinite(trainer.losses).all()
    assert [set(t) for t in timings] == [
        {"prepare", "forward+backward", "optimizer"}] * 2
    assert max(float(b[m][n].up.detach().abs().max())
               for b in state.adapters.blocks for m in b for n in b[m]) > 0
    for k, v in dit.state_dict().items():
        assert torch.equal(v, base[k]), k

    full = CoFTrainer(dit, vae, t5, None,
                      TrainerConfig(**TINY_TCFG, learning_rate=1e-3),
                      device="cpu")
    full.train(_samples(), total_steps=1)
    assert not torch.equal(dit.blocks[0].ffn.fc1.weight, base[
        "blocks.0.ffn.fc1.weight"])


def test_trainer_guards(tmp_path):
    _, (dit, vae, t5) = _trainer_pair(TINY_TCFG)
    # checkpoints are ported (tests/test_torch_train_checkpoint.py): a
    # checkpoint_dir is taken, and nothing is written before a step
    trainer = CoFTrainer(dit, vae, t5, None,
                         TrainerConfig(**TINY_TCFG,
                                       checkpoint_dir=str(tmp_path / "ckpt")),
                         device="cpu")
    assert trainer.tcfg.checkpoint_dir and not (tmp_path / "ckpt").exists()
    # a mesh is ported (tests/test_torch_parallel_train.py): it needs the
    # torch.distributed world it spans
    with pytest.raises(RuntimeError, match="torch.distributed"):
        CoFTrainer(dit, vae, t5, None, TrainerConfig(**TINY_TCFG, mesh_seq=2),
                   device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):     # the device defaults to CUDA
            CoFTrainer(dit, vae, t5, None, TrainerConfig(**TINY_TCFG))
