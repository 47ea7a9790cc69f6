"""The port's tensor parallelism of the Wan DiT against the JAX package's:
the TP forward (tp 2 and 4, tp 2 x Ulysses seq 2,
tp 2 x ring seq 2, data 2 x tp 2 with CFG parallelism, i2v), the shard
shapes, fp8 shards, runtime LoRA adapters cut with their weights, the CoF
edit and the Wan2.2 edit under `enable_sequence_parallel(model=2)` (with
and without CFG parallelism), the TP x FSDP training step, and its train
state saved at the model's global shapes and restored into each layout
(FSDP over data 2, TP over model 2, data 2 x model 2) and into one
process.

The port runs in gloo worlds of 2 and 4 CPU processes spawned once per
world size (`_torch_parallel_ranks.run_world`), each rank holding only its
shards; JAX runs in this process on the 8-device virtual CPU mesh
(`tests/conftest.py`), its parameters placed with `tp_param_shardings`.
Same weights (`videocof_torch.convert`), inputs and noise, float32.

Tolerances: the forwards 1e-4 (JAX's `test_tp_forward_exact`); fp8 3e-2
(JAX's `test_tp_shardings_handle_fp8_storage`: bf16 partial sums in other
orders); the edits' final latents 2e-4 and their uint8 frames one level
(`test_torch_parallel.py`); the training step's loss 1e-4 of JAX's 3D
step, its gradients 1e-4 relative, and every updated parameter within 2e-2
lr of the world-1 step's (`test_torch_parallel_train.py`). A step from a
restored state equals the step from the state in memory bit for bit in the
same layout; across layouts (restored in one process) it is held to the
same gates: the loss against JAX's second step, the moves against the
sharded second step's.
"""

import numpy as np
import pytest
import torch

from _torch_parallel_ranks import TP_LAYOUTS, run_world

torch.set_num_threads(1)

WORLDS = (2, 4)
PROMPT = "remove the red ball"
NEGATIVE = "blurry"
FWD_TOL = dict(rtol=1e-4, atol=1e-4)
FP8_TOL = dict(rtol=3e-2, atol=3e-2)
LAT_TOL = dict(rtol=2e-4, atol=2e-4)
LR = 1e-3
FULL_CLIP = 0.05
FSDP_MIN = 1024
LORA_RANKS = {("self_attn", "q"): 4, ("self_attn", "o"): 3,
              ("cross_attn", "k"): 2, ("cross_attn", "o"): 2,
              ("ffn", "fc1"): 3, ("ffn", "fc2"): 4}
CASES = ("tp_forward", "tp_edits", "tp_train", "train_resume")


def _as_np(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def _inputs(cfg, batch, rng):
    from videocof_tpu.models import wan_dit as jdit
    f, h, w = 3, 2, 2
    x = rng.standard_normal((batch, cfg.in_dim, f, 2 * h, 2 * w)
                            ).astype(np.float32)
    t = np.linspace(900.0, 300.0, batch).astype(np.float32)
    ctx = rng.standard_normal((batch, cfg.text_len, cfg.text_dim)
                              ).astype(np.float32)
    cos, sin = jdit.make_rope_for_geometry(cfg, (f, h, w))
    return [x, t, ctx, np.asarray(cos, np.float32),
            np.asarray(sin, np.float32)]


def _runtime_lora(cfg):
    from videocof_torch.models.lora import LoRAAdapters
    ad = LoRAAdapters(cfg, 1, 1.0, ranks=LORA_RANKS)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in ad.parameters():
            p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return ad


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """JAX's weights and outputs, and the payload the ranks take."""
    import jax
    import jax.numpy as jnp
    from videocof_tpu.configs import T5_TINY, VAE_TINY, WAN_TINY
    from videocof_tpu.configs import WanDiTConfig as JCfg
    from videocof_tpu.models import t5_encoder as jt5
    from videocof_tpu.models import wan_dit as jdit
    from videocof_tpu.models import wan_vae as jvae
    from videocof_tpu.parallel import (SPContext, make_mesh,
                                       make_ring_attention,
                                       make_tp_attention,
                                       tp_param_shardings)
    from videocof_tpu.training import train_step as jstep
    from videocof_torch import convert
    from videocof_torch.configs import T5Config, WanDiTConfig, WanVAEConfig

    rng = np.random.default_rng(0)
    cfg = JCfg(dim=64, ffn_dim=128, num_heads=4, num_layers=2, text_dim=32,
               text_len=16, freq_dim=32)
    icfg = cfg.replace(model_type="i2v", in_dim=2 * cfg.in_dim + 4)
    params = jdit.init_wan_dit(jax.random.PRNGKey(1), cfg)
    iparams = jdit.init_wan_dit(jax.random.PRNGKey(6), icfg)
    tp_in, tp_in2 = _inputs(cfg, 1, rng), _inputs(cfg, 2, rng)
    i2v_in = _inputs(cfg, 1, rng)
    i2v_kw = {"clip_fea": rng.standard_normal((1, 257, 1280)
                                              ).astype(np.float32),
              "y": rng.standard_normal((1, cfg.in_dim + 4, 3, 4, 4)
                                       ).astype(np.float32)}

    def fwd(p, c, args, mesh=None, attn=None, sp=None, **kw):
        if mesh is not None:
            p = jax.device_put(p, tp_param_shardings(mesh, p))
        out, _ = jax.jit(lambda q, *a: jdit.wan_dit_forward_with_residual(
            q, c, *a, attn_backend=attn, sp=sp,
            **{k: jnp.asarray(v) for k, v in kw.items()}))(
            p, *[jnp.asarray(a) for a in args])
        return np.asarray(out)

    base, base2 = fwd(params, cfg, tp_in), fwd(params, cfg, tp_in2)
    jtp = {}
    for name, ((d, s, m), mode) in {**TP_LAYOUTS[2], **TP_LAYOUTS[4]}.items():
        mesh = make_mesh(data=d, seq=s, model=m)
        if mode == "ring":
            attn, sp = make_ring_attention(mesh, model_axis="model"), None
        else:
            attn = make_tp_attention(
                mesh, seq_axis="seq" if mode == "ulysses" else None)
            sp = SPContext(mesh) if mode == "ulysses" else None
        jtp[name] = fwd(params, cfg, tp_in2 if name.endswith("cfg")
                        else tp_in, mesh, attn, sp)
    i2v_base = fwd(iparams, icfg, i2v_in, **i2v_kw)

    # the edits
    dcfg = WAN_TINY.replace(in_dim=VAE_TINY.z_dim, out_dim=VAE_TINY.z_dim,
                            text_dim=T5_TINY.dim)
    ep = {"dit": jdit.init_wan_dit(jax.random.PRNGKey(0), dcfg),
          "dit_2": jdit.init_wan_dit(jax.random.PRNGKey(4), dcfg),
          "vae": jvae.init_wan_vae(jax.random.PRNGKey(1), VAE_TINY),
          "t5": jt5.init_t5_encoder(jax.random.PRNGKey(2), T5_TINY)}
    video = rng.integers(0, 256, (1, 3, 9, 32, 48), dtype=np.uint8)
    noise = rng.standard_normal((1, VAE_TINY.z_dim, 4, 4, 6)
                                ).astype(np.float32)

    # the training step: JAX's 3D step (data 2 x seq 2 x model 2)
    B, F = 4, 5
    cos, sin = jdit.make_rope_for_geometry(dcfg, (F, 2, 4), f_src=2,
                                           f_ground=1)
    mask = np.ones(F, np.float32)
    mask[:2] = 0.0
    batch = {
        "x0": rng.standard_normal((B, dcfg.in_dim, F, 4, 8)
                                  ).astype(np.float32),
        "context": rng.standard_normal((B, dcfg.text_len, dcfg.text_dim)
                                       ).astype(np.float32),
        "rope_cos": np.asarray(cos, np.float32),
        "rope_sin": np.asarray(sin, np.float32),
        "timesteps": np.array([100, 400, 650, 900], np.int32),
        "frame_mask": mask}
    key = jax.random.PRNGKey(7)
    train_noise = np.array(jax.random.normal(key, batch["x0"].shape,
                                             jnp.float32))
    import optax
    tx = optax.chain(optax.clip_by_global_norm(FULL_CLIP),
                     optax.adamw(LR, weight_decay=1e-3))
    init_fn, step_fn = jstep.make_train_step(
        make_mesh(data=2, seq=2, model=2), dcfg, tx, use_ulysses=True,
        fsdp_min_size=FSDP_MIN)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    state1, loss3d = step_fn(init_fn(ep["dit"]), jbatch, key)
    # a second step, which the restored train states take
    key2 = jax.random.PRNGKey(8)
    train_noise2 = np.array(jax.random.normal(key2, batch["x0"].shape,
                                              jnp.float32))
    _, loss3d_2 = step_fn(state1, jbatch, key2)

    tcfg = convert.config_from(WanDiTConfig, cfg)
    lora = _runtime_lora(tcfg)
    payload = {
        "tp_dit": convert.dit_from_jax(_as_np(params)), "tp_dit_cfg": tcfg,
        "dit_b": convert.dit_from_jax(_as_np(jdit.init_wan_dit(
            jax.random.PRNGKey(5), cfg))),
        "i2v_dit": convert.dit_from_jax(_as_np(iparams)),
        "i2v_dit_cfg": convert.config_from(WanDiTConfig, icfg),
        "tp_in": tp_in, "tp_in2": tp_in2, "i2v_in": i2v_in,
        "i2v_kw": i2v_kw, "lora": lora.state_dict(),
        "lora_ranks": LORA_RANKS, "lora_scale": 0.5,
        "dit_cfg": convert.config_from(WanDiTConfig, dcfg),
        "vae_cfg": convert.config_from(WanVAEConfig, VAE_TINY),
        "t5_cfg": convert.config_from(T5Config, T5_TINY),
        "dit": convert.dit_from_jax(_as_np(ep["dit"])),
        "dit_2": convert.dit_from_jax(_as_np(ep["dit_2"])),
        "vae": convert.vae_from_jax(_as_np(ep["vae"])),
        "t5": convert.t5_from_jax(_as_np(ep["t5"])),
        "video": video, "noise": noise, "prompt": PROMPT,
        "negative_prompt": NEGATIVE,
        "edit_kw": dict(source_frames=9, reasoning_frames=4,
                        num_inference_steps=2, seed=11),
        "batch": batch, "train_noise": train_noise, "lr": LR,
        "full_clip": FULL_CLIP, "fsdp_min_size": FSDP_MIN,
        "train_noise2": train_noise2,
        "ckpt_root": str(tmp_path_factory.mktemp("train_states")),
    }
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VIDEOCOF_FETCH_YUV420", "0")
        mp.setenv("VIDEOCOF_STEPWISE", "1")
        yield {"params": ep, "dcfg": dcfg, "cfg": cfg, "base": base,
               "base2": base2, "jtp": jtp, "i2v_base": i2v_base,
               "loss3d": float(loss3d), "loss3d_2": float(loss3d_2),
               "payload": payload}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, jax_side, tmp_path_factory):
    """(world, [rank -> {case: result}]) of one spawn of the world."""
    world = request.param
    return world, run_world(world, tmp_path_factory.mktemp("tp"), CASES,
                            jax_side["payload"])


@pytest.fixture(scope="module")
def jax_edits(jax_side):
    """JAX's edits under TP: the CoF edit and the Wan2.2 edit over seq 2 x
    model 2 (the port's over model 2 alone are held to them too: every
    layout computes the same edit), the CFG edits over data 2 x model 2
    with CFG parallelism."""
    import jax.numpy as jnp
    from videocof_tpu.configs import T5_TINY, VAE_TINY
    from videocof_tpu.parallel import make_mesh
    from videocof_tpu.pipeline import Wan22Pipeline, WanPipeline
    js, pl = jax_side, jax_side["payload"]
    p = js["params"]
    kw = dict(noise=pl["noise"], output_latents=True, fused_sampling=False,
              **pl["edit_kw"])
    args = (p["dit"], js["dcfg"], p["vae"], VAE_TINY, p["t5"], T5_TINY)

    def pipe(moe, shape, cfg_parallel=False):
        pp = (Wan22Pipeline(*args, dit_params_2=p["dit_2"], boundary=0.9,
                            dtype=jnp.float32) if moe else
              WanPipeline(*args, dtype=jnp.float32))
        pp.enable_sequence_parallel(mesh=make_mesh(*shape),
                                    cfg_parallel=cfg_parallel)
        return pp

    moe_kw = {**kw, "num_inference_steps": 4, "guidance_scale": 1.0}
    cfg_kw = dict(guidance_scale=5.0, negative_prompt=NEGATIVE)
    return {"cof": pipe(False, (1, 2, 2))(pl["video"], PROMPT, **kw),
            "wan22": pipe(True, (1, 2, 2))(pl["video"], PROMPT, **moe_kw),
            "cfg": pipe(False, (2, 1, 2), True)(pl["video"], PROMPT, **kw,
                                                **cfg_kw),
            "wan22_cfg": pipe(True, (2, 1, 2), True)(
                pl["video"], PROMPT, **{**moe_kw, **cfg_kw})}


def _same_edit(got, want):
    np.testing.assert_allclose(got["latents"], want.latents, **LAT_TOL)
    assert np.abs(got["videos"] - want.videos).max() * 255 <= 1.0 + 1e-3
    if want.ground_videos is not None:
        assert np.abs(got["ground_videos"] - want.ground_videos
                      ).max() * 255 <= 1.0 + 1e-3


# --------------------------------------------------------------- forward

def test_tp_forward_matches_jax(ranks, jax_side):
    """The DiT forward over each of the world's TP layouts on every rank
    against JAX's forward over the same layout and its unsharded one: tp
    2 (world 2); tp 4, tp 2 x Ulysses seq 2, tp 2 x ring seq 2 and data 2
    x tp 2 with CFG parallelism on a batch of 2 (world 4)."""
    world, res = ranks
    for name in TP_LAYOUTS[world]:
        base = jax_side["base2" if name.endswith("cfg") else "base"]
        np.testing.assert_allclose(jax_side["jtp"][name], base, **FWD_TOL)
        for r, got in enumerate(res):
            np.testing.assert_allclose(got["tp_forward"][name], base,
                                       **FWD_TOL, err_msg=f"{name} {r}")
            np.testing.assert_allclose(got["tp_forward"][name],
                                       jax_side["jtp"][name], **FWD_TOL)


def test_tp_i2v_forward_matches_jax(ranks, jax_side):
    """The i2v DiT at tp = world: k_img, v_img and norm_k_img column-cut,
    against JAX's i2v forward."""
    world, res = ranks
    want = jax_side["i2v_base"]
    for got in res:
        np.testing.assert_allclose(got["tp_forward"]["i2v"], want,
                                   rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_tp_param_shards_are_fractional(ranks, jax_side):
    """Each rank's shard shapes at tp = world (a quarter at tp 4): the
    column-parallel out dim with its bias and q/k norm, the row-parallel
    in dim with its bias whole, the modulation whole."""
    world, res = ranks
    d, f = jax_side["cfg"].dim, jax_side["cfg"].ffn_dim
    want = {"blocks.0.self_attn.q.weight": (d // world, d),
            "blocks.0.self_attn.q.bias": (d // world,),
            "blocks.0.self_attn.norm_q.weight": (d // world,),
            "blocks.1.cross_attn.k.weight": (d // world, d),
            "blocks.0.ffn.fc1.weight": (f // world, d),
            "blocks.0.self_attn.o.weight": (d, d // world),
            "blocks.0.self_attn.o.bias": (d,),
            "blocks.0.ffn.fc2.weight": (d, f // world),
            "blocks.0.ffn.fc2.bias": (d,),
            "blocks.0.modulation": (6, d),
            "head.fc.weight": (jax_side["payload"]["tp_dit"][
                "head.fc.weight"].shape)}
    for got in res:
        shapes = got["tp_forward"]["shapes"]
        for k, v in want.items():
            assert shapes[k] == tuple(v), k


def test_tp_fp8_shards_keep_the_whole_scale(ranks, jax_side):
    """fp8: the weight quantized whole, then cut (float8_e4m3fn shards of
    the column shape), each shard with the whole tensor's scale; the TP
    forward against the unsharded fp8 forward."""
    from _torch_parallel_ranks import _dit
    from videocof_torch.utils.fp8 import quantize_dit_fp8
    world, res = ranks
    p = jax_side["payload"]
    q = quantize_dit_fp8(_dit(p["tp_dit"], p["tp_dit_cfg"]))
    scale = float(q.blocks[0].self_attn.q.weight_scale)
    with torch.no_grad():
        want = q(*[torch.from_numpy(a) for a in p["tp_in"]]).numpy()
    d = jax_side["cfg"].dim
    for got in res:
        dtype, shape, s = got["tp_forward"]["fp8_q"]
        assert dtype == "torch.float8_e4m3fn"
        assert shape == (d // world, d)
        assert s == scale
        np.testing.assert_allclose(got["tp_forward"]["fp8"], want, **FP8_TOL)


def test_tp_runtime_lora_matches_unsharded(ranks, jax_side):
    """Runtime LoRA adapters on q, o, cross k/o, fc1 and fc2, each cut with
    its base weight inside the block's call, at tp = world, against the
    unsharded runtime-LoRA forward."""
    from _torch_parallel_ranks import _dit
    from videocof_torch.models.lora import LoRAAdapters
    world, res = ranks
    p = jax_side["payload"]
    dit = _dit(p["tp_dit"], p["tp_dit_cfg"])
    ad = LoRAAdapters(p["tp_dit_cfg"], 1, 1.0, ranks=LORA_RANKS)
    ad.load_state_dict(p["lora"])
    dit.runtime_lora = (ad, p["lora_scale"])
    with torch.no_grad():
        want = dit(*[torch.from_numpy(a) for a in p["tp_in"]]).numpy()
        plain = _dit(p["tp_dit"], p["tp_dit_cfg"])(
            *[torch.from_numpy(a) for a in p["tp_in"]]).numpy()
    assert np.abs(want - plain).max() > 1e-3       # the adapters matter
    for got in res:
        np.testing.assert_allclose(got["tp_forward"]["lora"], want,
                                   **FWD_TOL)


# ------------------------------------------------------------------ edits

def test_tp_pipeline_matches_jax(ranks, jax_edits):
    """The 2-step CoF edit under `enable_sequence_parallel(seq=2,
    model=2)` (world 4; model=2 at world 2) on every rank against JAX's
    over seq 2 x model 2 (`test_tp_pipeline_matches_single_device`); and
    `disable_sequence_parallel` gives the local backend back."""
    world, res = ranks
    for got in res:
        _same_edit(got["tp_edits"]["cof"], jax_edits["cof"])
        assert got["tp_edits"]["disabled_backend"] is None


def test_tp_wan22_moe_pipeline_matches_jax(ranks, jax_edits, jax_side):
    """The Wan2.2 edit (4 steps, boundary 0.9) with both experts cut
    (their q weights half the rows) against JAX's
    (`test_tp_wan22_moe_pipeline_matches_single_device`)."""
    world, res = ranks
    d = jax_side["dcfg"].dim
    for got in res:
        _same_edit(got["tp_edits"]["wan22"], jax_edits["wan22"])
        assert got["tp_edits"]["expert_q"] == [(d // 2, d)] * 2


def test_tp_cfg_parallel_edits_match_jax(ranks, jax_edits):
    """data 2 x model 2 with CFG parallelism (guidance 5, one branch a data
    rank): the CoF edit and the Wan2.2 edit against JAX's."""
    world, res = ranks
    if world == 2:
        pytest.skip("data 2 x model 2 needs a world of 4")
    for got in res:
        _same_edit(got["tp_edits"]["cfg"], jax_edits["cfg"])
        _same_edit(got["tp_edits"]["wan22_cfg"], jax_edits["wan22_cfg"])


# --------------------------------------------------------------- training

@pytest.fixture(scope="module")
def one_step(jax_side):
    """The port's world-1 full fine-tuning step on the same batch: (loss,
    gradients AdamW took, parameters before, parameters after)."""
    from _torch_parallel_ranks import _batch, _dit, _np, record_grads
    from videocof_torch.training.train_step import adamw, make_train_step
    p = jax_side["payload"]
    dit = _dit(p["dit"], p["dit_cfg"])
    before = {k: _np(v) for k, v in dit.state_dict().items()}
    init_fn, step_fn = make_train_step(dit, adamw(LR, 1e-3, FULL_CLIP))
    state = init_fn()
    grads = record_grads(state)
    state, loss = step_fn(state, _batch(p, slice(None)),
                          noise=torch.from_numpy(p["train_noise"]))
    after = {k: _np(v) for k, v in state.params.state_dict().items()}
    return float(loss), grads, before, after


def test_tp_fsdp_step_matches_jax_and_world_1(ranks, jax_side, one_step):
    """One full fine-tuning step over data world/2 x model 2 (TP shards,
    FSDP over data on the dim TP left free; the clip binds): the loss
    against JAX's 3D step and the world-1 step, the gradients AdamW took
    and every updated parameter (this rank's TP shard, FSDP-gathered)
    against the world-1 step's, cut the same way."""
    from videocof_torch.parallel.tp import shard_param
    world, res = ranks
    loss1, grads, before, after = one_step
    np.testing.assert_allclose(loss1, jax_side["loss3d"], rtol=1e-4)
    gmax = max(float(np.abs(v).max()) for v in grads.values())
    d = jax_side["dcfg"].dim
    for got in res:
        out = got["tp_train"]
        np.testing.assert_allclose(out["loss"], jax_side["loss3d"],
                                   rtol=1e-4, atol=1e-4)
        m = out["model_rank"]
        # the q weight: TP's rows and FSDP's columns, a quarter a rank
        assert out["q_local"] == ((d // 2, d // 2) if world == 4
                                  else (d // 2, d))
        assert set(out["trained"]) == set(after)
        for k, v in out["trained"].items():
            cut = {n: shard_param(k, torch.from_numpy(a), out["dims"][k], 2,
                                  m).numpy()
                   for n, a in (("g", grads[k]), ("w0", before[k]),
                                ("w1", after[k]))}
            np.testing.assert_allclose(out["grads"][k], cut["g"], rtol=1e-4,
                                       atol=1e-4 * gmax, err_msg=k)
            np.testing.assert_allclose(v - cut["w0"], cut["w1"] - cut["w0"],
                                       rtol=0, atol=2e-2 * LR, err_msg=k)


def test_tp_replicated_grads_agree_over_model(ranks):
    """The parameters every model rank holds whole get the same gradient
    on each (the f/g pair makes it whole: no model-axis reduction)."""
    world, res = ranks
    for r0 in range(0, world, 2):
        a, b = res[r0]["tp_train"], res[r0 + 1]["tp_train"]
        assert (a["model_rank"], b["model_rank"]) == (0, 1)
        whole = [k for k, dim in a["dims"].items() if dim is None]
        assert whole
        for k in whole:
            np.testing.assert_allclose(a["grads"][k], b["grads"][k],
                                       rtol=1e-6, atol=1e-7, err_msg=k)


# ------------------------------------------------------------ train states

def _resumes(res):
    """(rank, layout, record) of every layout each rank ran."""
    return [(r, shape, rec) for r, got in enumerate(res)
            for shape, rec in got["train_resume"].items()]


def test_train_state_restores_into_its_layout_bit_for_bit(ranks):
    """In each layout (data 2, model 2, data 2 x model 2) a fresh state
    restored from the file holds exactly this rank's shards of the saved
    state, and its next step equals the next step of the state in memory
    bit for bit (loss, parameters, AdamW's moments and step counts)."""
    world, res = ranks
    from _torch_parallel_ranks import RESUME_LAYOUTS
    assert {s for _, s, _ in _resumes(res)} == set(RESUME_LAYOUTS[world])
    for r, shape, rec in _resumes(res):
        assert rec["n_held"] > 0
        assert rec["restored_differ"] == [], (r, shape)
        assert rec["loss2_restored"] == rec["loss2"], (r, shape)
        assert rec["step2_differ"] == [], (r, shape)


def test_save_returns_once_the_directory_exists(ranks):
    """Every rank returns from `save_train_state` only once rank 0's
    directory is there (the other ranks used to return at once)."""
    world, res = ranks
    for r, shape, rec in _resumes(res):
        assert rec["there"], (r, shape)
        assert rec["path"] == res[0]["train_resume"][shape]["path"]


def test_train_state_is_saved_at_global_shapes(ranks, one_step):
    """The file holds every parameter and AdamW moment at the model's
    global shape, whatever the layout (a TP state used to be written with
    model rank 0's slices), and its parameters are the sharded step's
    gathered whole."""
    import os
    world, res = ranks
    _, _, before, _ = one_step
    for shape, rec in res[0]["train_resume"].items():
        payload = torch.load(os.path.join(rec["path"], "train_state.pt"),
                             weights_only=True)
        params = payload["params"]
        assert set(params) == set(before)
        for k, v in params.items():
            assert tuple(v.shape) == before[k].shape, (shape, k)
        moments = [st["exp_avg"] for st in payload["optimizer"]["state"]
                   .values()]
        assert sorted(tuple(m.shape) for m in moments) == sorted(
            before[k].shape for k in before), shape


def test_train_state_restores_at_world_1(ranks, jax_side):
    """The file of each layout restored into a one-process state: its
    second step's loss within 1e-4 of JAX's second 3D step, and every
    parameter's move within 2e-2 lr of the sharded second step's
    (`test_tp_fsdp_step_matches_jax_and_world_1`'s gates)."""
    import os
    from _torch_parallel_ranks import _batch, full_state
    from videocof_torch.utils import checkpoint
    world, res = ranks
    p = jax_side["payload"]
    for shape, rec in res[0]["train_resume"].items():
        state, step_fn = full_state(p)
        checkpoint.restore_train_state(os.path.dirname(rec["path"]), state)
        saved = torch.load(os.path.join(rec["path"], "train_state.pt"),
                           weights_only=True)["params"]
        assert state.step == 1
        state, loss = step_fn(state, _batch(p, slice(None)),
                              noise=torch.from_numpy(p["train_noise2"]))
        np.testing.assert_allclose(float(loss), jax_side["loss3d_2"],
                                   rtol=1e-4, atol=1e-4, err_msg=str(shape))
        for k, v in state.params.state_dict().items():
            w1 = saved[k].numpy()
            np.testing.assert_allclose(v.numpy() - w1,
                                       rec["whole2"][k] - w1, rtol=0,
                                       atol=2e-2 * LR,
                                       err_msg=f"{shape} {k}")
