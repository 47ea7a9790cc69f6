"""The port's sequence, CFG and data parallelism against the JAX package's:
the mesh, the SP padding helpers, Ulysses and ring attention, the whole
sequence-parallel DiT forward, the CoF edit under Ulysses, ring and CFG
parallelism, the Wan2.2 edit under SP, and the FSDP rule.

The port runs in gloo worlds of 2 and 4 CPU processes, spawned once per
world size (`_torch_parallel_ranks.run_world`), each rank holding only its
shards; JAX runs in this process on the 8-device virtual CPU mesh
(`tests/conftest.py`) and on one device. Both sides take the same numpy
inputs, the same weights (`videocof_torch.convert`) and the same noise, in
float32. JAX is imported inside the functions: the spawned ranks import
none of it.

Tolerances: attention and the DiT forward in fp32, 2e-5 (rtol and atol,
the einsum paths; 1e-4 for the DiT, whose 2 blocks add the reductions'
orders); the edits' final latents 2e-4, as the port's one-device edit is
held to JAX's (`test_torch_pipeline.py`), and their uint8 frames one level.
"""

import numpy as np
import pytest
import torch

from _torch_parallel_ranks import run_world

torch.set_num_threads(1)

WORLDS = (2, 4)
PROMPT = "remove the red ball"
NEGATIVE = "blurry"
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
DIT_TOL = dict(rtol=1e-4, atol=1e-4)
LAT_TOL = dict(rtol=2e-4, atol=2e-4)
FSDP_MIN = 1024
# the (data, seq, model) meshes of each world whose coordinates are held
MESH_SHAPES = {2: [(1, 1, 2), (1, 2, 1), (2, 1, 1)],
               4: [(1, 1, 4), (1, 2, 2), (2, 1, 2), (2, 2, 1), (4, 1, 1)]}
CASES = ("mesh", "mesh3d", "collectives", "attention24", "ring128", "dit",
         "pipeline", "cfg_parallel", "wan22", "fsdp")


def _as_np(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX weights and configs, and the payload the ranks take."""
    import jax
    from videocof_tpu.configs import T5_TINY, VAE_TINY, WAN_TINY
    from videocof_tpu.models import t5_encoder as jt5
    from videocof_tpu.models import wan_dit as jdit
    from videocof_tpu.models import wan_vae as jvae
    from videocof_torch import convert
    from videocof_torch.configs import T5Config, WanDiTConfig, WanVAEConfig

    dcfg = WAN_TINY.replace(in_dim=VAE_TINY.z_dim, out_dim=VAE_TINY.z_dim,
                            text_dim=T5_TINY.dim)
    params = {"dit": jdit.init_wan_dit(jax.random.PRNGKey(0), dcfg),
              "dit_2": jdit.init_wan_dit(jax.random.PRNGKey(4), dcfg),
              "vae": jvae.init_wan_vae(jax.random.PRNGKey(1), VAE_TINY),
              "t5": jt5.init_t5_encoder(jax.random.PRNGKey(2), T5_TINY)}
    rng = np.random.default_rng(0)

    def qkvm(shape, keep):
        q, k, v = (rng.standard_normal(shape).astype(np.float32)
                   for _ in range(3))
        m = np.ones(shape[:2], bool)
        m[:, keep:] = False
        if shape[0] > 1:
            m[-1, :] = False
            m[-1, 3] = True       # a batch row of one key
        return {"q": q, "k": k, "v": v, "m": m}

    # the DiT forward: 5 x 3 x 3 = 45 tokens, dividing neither 2 nor 4
    f, h, w = 5, 3, 3
    x = rng.standard_normal((1, dcfg.in_dim, f, 2 * h, 2 * w)
                            ).astype(np.float32)
    ctx = rng.standard_normal((1, dcfg.text_len, dcfg.text_dim)
                              ).astype(np.float32)
    cos, sin = jdit.make_rope_for_geometry(dcfg, (f, h, w), f_src=2,
                                           f_ground=1)
    # the edit: 9 source frames at 32x48 -> 3 + 1 + 3 latent frames of 4x6
    # = 84 tokens (dividing 2 and 4)
    video = rng.integers(0, 256, (1, 3, 9, 32, 48), dtype=np.uint8)
    noise = rng.standard_normal((1, VAE_TINY.z_dim, 4, 4, 6)
                                ).astype(np.float32)
    tcfg = convert.config_from(WanDiTConfig, dcfg)
    payload = {
        "dit_cfg": tcfg,
        "vae_cfg": convert.config_from(WanVAEConfig, VAE_TINY),
        "t5_cfg": convert.config_from(T5Config, T5_TINY),
        "dit": convert.dit_from_jax(_as_np(params["dit"])),
        "dit_2": convert.dit_from_jax(_as_np(params["dit_2"])),
        "vae": convert.vae_from_jax(_as_np(params["vae"])),
        "t5": convert.t5_from_jax(_as_np(params["t5"])),
        "attn24": qkvm((2, 32, 4, 24), 27),
        # keys from 40 masked: at 4 ranks the last rotated shard is
        # wholly masked (B2's finite LSE keeps the combine finite)
        "attn128": qkvm((1, 64, 2, 128), 40),
        "dit_in": [x, np.array([500.0], np.float32), ctx,
                   np.asarray(cos, np.float32), np.asarray(sin, np.float32)],
        "video": video, "noise": noise, "prompt": PROMPT,
        "negative_prompt": NEGATIVE,
        "edit_kw": dict(source_frames=9, reasoning_frames=4,
                        num_inference_steps=2, seed=11),
        "fsdp_min_size": FSDP_MIN, "mesh_shapes": MESH_SHAPES,
        "coll": rng.standard_normal((2, 8, 4, 3)).astype(np.float32),
        "coll_w": rng.standard_normal((2, 8, 4, 3)).astype(np.float32),
    }
    # JAX's stepwise loop with uint8 RGB output, as the port runs it
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VIDEOCOF_FETCH_YUV420", "0")
        mp.setenv("VIDEOCOF_STEPWISE", "1")
        yield {"params": params, "dcfg": dcfg, "vcfg": VAE_TINY,
               "t5cfg": T5_TINY, "payload": payload}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, jax_side, tmp_path_factory):
    """(world, [rank -> {case: result}]) of one spawn of the world."""
    world = request.param
    return world, run_world(world, tmp_path_factory.mktemp("sp"), CASES,
                            jax_side["payload"])


def _jax_pipeline(js, moe=False):
    import jax.numpy as jnp
    from videocof_tpu.pipeline import Wan22Pipeline, WanPipeline
    p = js["params"]
    args = (p["dit"], js["dcfg"], p["vae"], js["vcfg"], p["t5"], js["t5cfg"])
    if moe:
        return Wan22Pipeline(*args, dit_params_2=p["dit_2"], boundary=0.9,
                             dtype=jnp.float32)
    return WanPipeline(*args, dtype=jnp.float32)


@pytest.fixture(scope="module")
def jax_edits(jax_side):
    """JAX's edits: sequence-parallel over 4 devices in each mode, CFG
    parallel over data 2 x seq 2, and the Wan2.2 edit under Ulysses."""
    pl = jax_side["payload"]
    kw = dict(noise=pl["noise"], output_latents=True, fused_sampling=False,
              **pl["edit_kw"])
    pipe = _jax_pipeline(jax_side)
    out = {}
    for mode in ("ulysses", "ring"):
        pipe.enable_sequence_parallel(data=1, seq=4, mode=mode)
        out[mode] = pipe(pl["video"], PROMPT, **kw)
        pipe.disable_sequence_parallel()
    pipe.enable_sequence_parallel(data=2, seq=2, mode="ulysses",
                                  cfg_parallel=True)
    out["cfg"] = pipe(pl["video"], PROMPT, guidance_scale=5.0,
                      negative_prompt=NEGATIVE, **kw)
    pipe.disable_sequence_parallel()
    moe = _jax_pipeline(jax_side, moe=True)
    moe.enable_sequence_parallel(data=1, seq=4, mode="ulysses")
    out["wan22"] = moe(pl["video"], PROMPT, **{
        **kw, "num_inference_steps": 4, "guidance_scale": 1.0})
    return out


def _shards(x, world, rank):
    return np.array_split(x, world, axis=1)[rank]


# ------------------------------------------------------------------- mesh

def test_mesh_axes(ranks):
    world, res = ranks
    for r, got in enumerate(res):
        axes, d, s = got["mesh"]["data1"]
        assert axes == {"data": 1, "seq": world, "model": 1}
        assert (d, s) == (0, r)
        axes, d, s = got["mesh"]["data2"]
        assert axes == {"data": 2, "seq": world // 2, "model": 1}
        assert (d, s) == (r // (world // 2), r % (world // 2))
        assert "needs" in got["mesh"]["too_big"]




def test_make_mesh_coordinates_match_jax(ranks):
    """Rank r sits at (d, s, m) with r = (d * seq + s) * model + m, model
    innermost: the position of device r in JAX's `Mesh.devices`, for every
    mesh of the world's size (a model axis included)."""
    from videocof_tpu.parallel import make_mesh
    world, res = ranks
    for shape in MESH_SHAPES[world]:
        ids = np.vectorize(lambda d: d.id)(make_mesh(*shape).devices)
        for r, got in enumerate(res):
            want = tuple(int(i) for i in np.argwhere(ids == r)[0])
            assert got["mesh3d"][shape] == want, (shape, r)


def test_rank_device_raises_without_cuda(monkeypatch):
    """Without CUDA a rank's device is no silent CPU: rank_device raises,
    whatever LOCAL_RANK says."""
    from videocof_torch.parallel import rank_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for local in ("0", "1"):
        monkeypatch.setenv("LOCAL_RANK", local)
        with pytest.raises(RuntimeError, match="CUDA"):
            rank_device()


def test_pad_helpers_match_jax():
    import jax.numpy as jnp
    from videocof_tpu.parallel import sp as jsp
    from videocof_torch.parallel import sp
    for L, n in ((30, 4), (32, 4), (45, 2), (1, 3)):
        assert sp.pad_tokens_for_sp(L, n) == jsp.pad_tokens_for_sp(L, n)
    x = np.random.default_rng(1).standard_normal((2, 45, 8)
                                                 ).astype(np.float32)
    np.testing.assert_array_equal(
        sp.pad_stream(torch.from_numpy(x), 4).numpy(),
        np.asarray(jsp.pad_stream(jnp.asarray(x), 4)))
    cos, sin = x[0, :, :4], x[1, :, :4]
    for got, want in zip(
            sp.pad_rope_tables(torch.from_numpy(cos), torch.from_numpy(sin),
                               48),
            jsp.pad_rope_tables(jnp.asarray(cos), jnp.asarray(sin), 48)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ragged = np.random.default_rng(2).random((2, 5)) > 0.5
    for lt in (3, ragged):
        want = jsp.joint_pad_masks(2, jnp.asarray(lt), 8, 6, 8)
        got = sp.joint_pad_masks(2, torch.as_tensor(lt), 8, 6, 8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_autograd_collectives(ranks, jax_side):
    """Each collective's value and the gradient its backward hands this
    rank: the all-to-all (tokens <-> heads; its backward the reverse
    all-to-all), the token gather (its backward this rank's slice) and the
    sum (its backward the identity), exact in fp32."""
    world, res = ranks
    x = jax_side["payload"]["coll"]
    w = jax_side["payload"]["coll_w"]
    for r, got in enumerate(res):
        out, grad = got["collectives"]["all_to_all"]
        np.testing.assert_array_equal(out, np.split(x, world, axis=2)[r])
        # every rank's loss reaches this rank's tokens through the
        # reverse all-to-all: the gradient of the ranks' summed losses
        np.testing.assert_array_equal(grad, _shards(w, world, r))
        out, grad = got["collectives"]["gather_tokens"]
        np.testing.assert_array_equal(out, x)
        np.testing.assert_array_equal(grad, _shards(w, world, r))
        out, grad = got["collectives"]["all_reduce_sum"]
        np.testing.assert_allclose(out, sum(_shards(x, world, s)
                                            for s in range(world)),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(grad, _shards(w, world, 0))


# -------------------------------------------------------------- attention

def test_ulysses_and_ring_match_naive(ranks, jax_side):
    """Ulysses (B1's place: the naive backend on the CPU) and ring's fp32
    einsum path at head dim 24, unmasked and with a key mask (a row of one
    key), against JAX's naive attention over the whole sequence."""
    import jax.numpy as jnp
    from videocof_tpu.ops import attention
    world, res = ranks
    a = jax_side["payload"]["attn24"]
    for masked in (False, True):
        want = np.asarray(attention(
            *(jnp.asarray(a[n]) for n in "qkv"),
            mask=jnp.asarray(a["m"]) if masked else None, backend="naive"))
        for r, got in enumerate(res):
            for mode in ("ulysses", "ring"):
                np.testing.assert_allclose(
                    got["attention24"][(mode, masked)],
                    _shards(want, world, r), **ATTN_TOL,
                    err_msg=f"{mode} masked={masked} rank {r}")


def test_ring_kernel_path_with_mask_matches_pallas(ranks, jax_side):
    """Ring at head dim 128 (B2's plain version per rotated shard, the fp32
    LSE combine) with a key mask against JAX's ring over its Pallas B2 in
    interpret mode on 4 devices (`test_ring_v2_kernel_path_with_mask`),
    every row, the masked tail's included."""
    import jax
    import jax.numpy as jnp
    from videocof_tpu.parallel import make_mesh, make_ring_attention
    world, res = ranks
    a = jax_side["payload"]["attn128"]
    want = np.asarray(jax.jit(make_ring_attention(make_mesh(data=1, seq=4)))(
        *(jnp.asarray(a[n]) for n in "qkvm")))
    for r, got in enumerate(res):
        np.testing.assert_allclose(got["ring128"]["out"],
                                   _shards(want, world, r), rtol=1e-4,
                                   atol=1e-4, err_msg=f"rank {r}")


# --------------------------------------------------------------------- DiT

@pytest.mark.parametrize("mode", ["ulysses", "ring"])
def test_dit_forward_non_dividing_tokens(ranks, jax_side, mode):
    """The whole DiT forward at 45 tokens (padded to the seq axis, the pad
    keys masked) against JAX's sequence-parallel forward on 4 devices."""
    import jax
    import jax.numpy as jnp
    from videocof_tpu.models import wan_dit as jdit
    from videocof_tpu.parallel import (SPContext, make_mesh,
                                       make_ring_attention,
                                       make_ulysses_attention)
    world, res = ranks
    mesh = make_mesh(data=1, seq=4)
    maker = {"ulysses": make_ulysses_attention,
             "ring": make_ring_attention}[mode]
    args = [jnp.asarray(a) for a in jax_side["payload"]["dit_in"]]
    want = np.asarray(jax.jit(lambda p, *a: jdit.wan_dit_forward(
        p, jax_side["dcfg"], *a, attn_backend=maker(mesh),
        sp=SPContext(mesh)))(jax_side["params"]["dit"], *args))
    for r, got in enumerate(res):
        np.testing.assert_allclose(got["dit"][mode], want, **DIT_TOL,
                                   err_msg=f"rank {r}")


def test_each_rank_holds_its_token_shard(ranks):
    """Every block runs on L/sp tokens: 45 tokens padded to a multiple of
    the world, over the world's ranks."""
    world, res = ranks
    Lp = -(-45 // world) * world
    for got in res:
        assert set(got["dit"]["block_input_shapes"]) == {
            (1, Lp // world, 96)}


# ------------------------------------------------------------------ edits

def _same_edit(got, want):
    np.testing.assert_allclose(got["latents"], want.latents, **LAT_TOL)
    # uint8 frames: a latent ulp may flip one level
    assert np.abs(got["videos"] - want.videos).max() * 255 <= 1.0 + 1e-3
    if want.ground_videos is not None:
        assert np.abs(got["ground_videos"] - want.ground_videos
                      ).max() * 255 <= 1.0 + 1e-3


@pytest.mark.parametrize("mode", ["ulysses", "ring"])
def test_cof_edit_matches_jax(ranks, jax_edits, mode):
    """The 2-step CoF edit, sequence-parallel over the world, on every rank
    against JAX's over 4 devices: final latents, videos and the grounding
    videos (CoF repeat-RoPE sharded with the tokens)."""
    world, res = ranks
    for got in res:
        _same_edit(got["pipeline"][mode], jax_edits[mode])


def test_cfg_parallel_matches_jax_and_world_1(ranks, jax_side, jax_edits):
    """The CFG edit (guidance 5) with one guidance branch per data rank
    (data 2 x seq world/2) against JAX's CFG-parallel edit and against the
    port's own one-process edit; each rank's blocks see one branch's row."""
    from _torch_parallel_ranks import _edit, _pipeline
    world, res = ranks
    pl = jax_side["payload"]
    one = _edit(_pipeline(pl), pl, guidance_scale=5.0,
                negative_prompt=NEGATIVE)
    for got in res:
        out = got["cfg_parallel"]
        _same_edit(out, jax_edits["cfg"])
        np.testing.assert_allclose(out["latents"], one["latents"],
                                   **LAT_TOL)
        assert {s[0] for s in out["block_input_shapes"]} == {1}


def test_cfg_parallel_teacache_across_cfg_skip(ranks, jax_side):
    """CFG parallelism with TeaCache replaying a CFG step's residual (each
    rank holds its branch's rows) on a step past cfg-skip's cut (the cond
    rows, gathered over the data ranks), against the port's one-process
    edit."""
    from _torch_parallel_ranks import TEACACHE_CFG_SKIP, _edit, _pipeline
    world, res = ranks
    pl = jax_side["payload"]
    one = _edit(_pipeline(pl), pl, **TEACACHE_CFG_SKIP)
    for got in res:
        out = got["cfg_parallel"]["teacache"]
        np.testing.assert_allclose(out["latents"], one["latents"], **LAT_TOL)
        assert np.abs(out["videos"] - one["videos"]).max() * 255 <= 1 + 1e-3


def test_cfg_parallel_needs_a_data_axis(ranks):
    world, res = ranks
    for got in res:
        assert "data axis" in got["pipeline"]["cfg_parallel_without_data"]


def test_wan22_edit_under_sp_matches_jax(ranks, jax_edits):
    """The Wan2.2 dual-expert edit (4 steps, boundary 0.9), both experts
    under Ulysses, against JAX's on 4 devices."""
    world, res = ranks
    for got in res:
        _same_edit(got["wan22"], jax_edits["wan22"])


# -------------------------------------------------------------------- FSDP

def test_fsdp_rule_matches_jax(ranks, jax_side):
    """The port's rule picks the dim JAX's `fsdp_param_sharding` shards for
    a leaf of the same shape, over a data axis of 2; `apply_fsdp` shards
    those parameters on that dim (half of it a rank) and leaves the rest
    whole."""
    import jax
    import jax.numpy as jnp
    from videocof_tpu.parallel import fsdp_param_sharding, make_mesh
    world, res = ranks
    mesh = make_mesh(data=2, seq=1)
    shapes = {k: v.shape for k, v in jax_side["payload"]["dit"].items()}
    jrule = fsdp_param_sharding(
        mesh, {k: jax.ShapeDtypeStruct(s, jnp.float32)
               for k, s in shapes.items()}, min_size=FSDP_MIN)
    want = {k: next((i for i, a in enumerate(sh.spec) if a == "data"), None)
            for k, sh in jrule.items()}
    assert any(d is not None for d in want.values())
    assert any(d is None for d in want.values())
    for got in res:
        assert got["fsdp"]["rule"] == want
        for k, (dim, local) in got["fsdp"]["placed"].items():
            assert dim == want[k], k
            full = list(shapes[k])
            if dim is not None:
                full[dim] //= 2
            assert local == tuple(full), k


def test_parallel_config_matches_jax():
    """`configs.ParallelConfig`: JAX's fields, defaults and ``world``,
    frozen."""
    import dataclasses
    from videocof_torch.configs import ParallelConfig
    from videocof_tpu.configs import ParallelConfig as JaxParallelConfig
    fields = [(f.name, f.default) for f in dataclasses.fields(ParallelConfig)]
    assert fields == [(f.name, f.default)
                      for f in dataclasses.fields(JaxParallelConfig)]
    assert fields == [("data", 1), ("seq", 1), ("seq_mode", "ulysses")]
    for kw in ({}, {"data": 2}, {"seq": 4, "seq_mode": "ring"},
               {"data": 2, "seq": 3}):
        got, want = ParallelConfig(**kw), JaxParallelConfig(**kw)
        assert (got.data, got.seq, got.seq_mode, got.world) == (
            want.data, want.seq, want.seq_mode, want.world)
    with pytest.raises(dataclasses.FrozenInstanceError):
        ParallelConfig().data = 2
