"""The port's data- and sequence-parallel training against the JAX
package's sharded steps: one LoRA step over ``data`` (the frozen base
FSDP-sharded), over ``seq`` (Ulysses, the gradient through the
differentiable all-to-alls) and over both, one full fine-tuning step with
FSDP-sharded parameters and AdamW moments, the timestep bands, and
`CoFTrainer` over a data axis against its own one-process run.

The port runs in gloo worlds of 2 and 4 CPU processes spawned once per
world size (`_torch_parallel_ranks.run_world`); JAX runs its
`make_lora_train_step` and `make_train_step` in this process on a data 2 x
seq 2 mesh of the 8-device virtual CPU mesh. Both sides take the same
weights, adapters, batch of 4 rows, timesteps and noise (JAX draws it in its
step from the key; the test draws the same array and hands each rank its
rows), in float32.

Tolerances: the loss 1e-5 relative; the adapters' gradients as AdamW
takes them (reduced over the mesh and clipped to the global norm) 1e-4
relative and 1e-4 of the largest; AdamW's first step moves each entry by
about lr, so the moves are compared within 1e-2 lr (LoRA: where JAX's
gradient is above 1e-3 of the largest, ten times the gradients' own
tolerance; a gradient within that tolerance of 0 may turn its move's sign)
and 2e-2 lr (full fine-tuning), as the one-device steps are
(`test_torch_training.py`).
"""

import numpy as np
import pytest
import torch

from _torch_parallel_ranks import run_world

torch.set_num_threads(1)

WORLDS = (2, 4)
LR = 1e-3
# the LoRA steps' clip never binds, so their gradients are compared at their
# reduced size (an average over seq would show as a factor of 1/sp, which a
# binding clip and AdamW's first step would hide); the full step's binds,
# so the global norm of the FSDP shards decides its clipped gradients
LORA_CLIP = 1e3
FULL_CLIP = 0.05
RANK = 4
FSDP_MIN = 1024
CASES = ("lora_data", "lora_seq", "lora_data_seq", "full_data", "trainer")


def _as_np(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def _tx(weight_decay, clip):
    import optax
    return optax.chain(optax.clip_by_global_norm(clip),
                       optax.adamw(LR, weight_decay=weight_decay))


def _clipped(grads, clip, binds):
    """optax's clip_by_global_norm of a numpy tree, which must bind or not
    as ``binds`` says."""
    import jax
    norm = np.sqrt(sum(float(np.square(g).sum())
                       for g in jax.tree.leaves(grads)))
    assert (norm >= clip) == binds, (norm, clip)
    return jax.tree.map(lambda g: g / norm * clip, grads) if binds else grads


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """JAX's weights, adapters, batch and noise, the results of its sharded
    steps, and the payload the ranks take."""
    import jax
    import jax.numpy as jnp
    from videocof_tpu.configs import T5_TINY, VAE_TINY, WAN_TINY
    from videocof_tpu.models import lora as jlora
    from videocof_tpu.models import t5_encoder as jt5
    from videocof_tpu.models import wan_dit as jdit
    from videocof_tpu.models import wan_vae as jvae
    from videocof_tpu.parallel import (SPContext, make_mesh,
                                       make_ulysses_attention)
    from videocof_tpu.training import train_step as jstep
    from videocof_torch import convert
    from videocof_torch.configs import T5Config, WanDiTConfig, WanVAEConfig
    from _tiny_train import TCFG, triplet

    dcfg = WAN_TINY.replace(in_dim=VAE_TINY.z_dim, out_dim=VAE_TINY.z_dim,
                            text_dim=T5_TINY.dim)
    params = jdit.init_wan_dit(jax.random.PRNGKey(0), dcfg)
    ad = jlora.init_lora_adapters(jax.random.PRNGKey(1), dcfg, rank=RANK)
    rng = np.random.default_rng(1)
    # a non-zero ``up``, so that ``down`` gets gradients too
    ad["blocks"] = jax.tree.map(
        lambda x: x + jnp.asarray(0.05 * rng.standard_normal(x.shape),
                                  x.dtype), ad["blocks"])
    B, F, f_src = 4, 5, 2
    cos, sin = jdit.make_rope_for_geometry(dcfg, (F, 2, 4), f_src=f_src,
                                           f_ground=1)
    mask = np.ones(F, np.float32)
    mask[:f_src] = 0.0
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
    noise = np.array(jax.random.normal(key, batch["x0"].shape, jnp.float32))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    mesh = make_mesh(data=2, seq=2)

    init_fn, step_fn = jstep.make_lora_train_step(
        mesh, dcfg, _tx(0.0, LORA_CLIP), rank=RANK, use_ulysses=True)
    state = init_fn(jax.random.PRNGKey(4))
    # the step donates its state: it gets a copy of the adapters
    ad0 = _as_np(ad)
    state = state._replace(adapters=jax.tree.map(jnp.array, ad0))
    state2, lora_loss = step_fn(state, params, jb, key)

    # the gradients the steps take: their loss's on the same mesh, clipped
    def loss(p, lora=None):
        return jstep.flow_matching_loss(
            p, dcfg, jb["x0"], jb["context"], jb["rope_cos"],
            jb["rope_sin"], jb["timesteps"], jnp.asarray(noise),
            attn_backend=make_ulysses_attention(mesh), remat=True,
            frame_mask=jb["frame_mask"], sp=SPContext(mesh), lora=lora)

    scale = float(ad0["alpha"]) / float(ad0["rank"])
    grads = _clipped(_as_np(jax.jit(jax.grad(
        lambda blocks: loss(params, (blocks, scale))))(
            jax.tree.map(jnp.array, ad0["blocks"]))), LORA_CLIP, False)
    full_grads = _clipped(_as_np(jax.jit(jax.grad(loss))(params)),
                          FULL_CLIP, True)

    init_fn, step_fn = jstep.make_train_step(
        mesh, dcfg, _tx(1e-3, FULL_CLIP), use_ulysses=True,
        fsdp_min_size=FSDP_MIN)
    fstate2, full_loss = step_fn(init_fn(params), jb, key)

    vae = jvae.init_wan_vae(jax.random.PRNGKey(2), VAE_TINY)
    t5 = jt5.init_t5_encoder(jax.random.PRNGKey(3), T5_TINY)
    payload = {
        "dit_cfg": convert.config_from(WanDiTConfig, dcfg),
        "vae_cfg": convert.config_from(WanVAEConfig, VAE_TINY),
        "t5_cfg": convert.config_from(T5Config, T5_TINY),
        "dit": convert.dit_from_jax(_as_np(params)),
        "vae": convert.vae_from_jax(_as_np(vae)),
        "t5": convert.t5_from_jax(_as_np(t5)),
        "adapters": ad0, "rank": RANK, "lora_clip": LORA_CLIP,
        "full_clip": FULL_CLIP,
        "fsdp_min_size": FSDP_MIN, "batch": batch, "noise": noise,
        "tcfg": dict(TCFG, batch_size=2, learning_rate=LR, lora_rank=RANK),
        "samples": [triplet(i, text=f"item {i}") for i in range(2)],
        "ckpt_dir": str(tmp_path_factory.mktemp("ckpt")),
    }
    return {"payload": payload, "ad0": ad0,
            "lora": (float(lora_loss), _as_np(state2.adapters)),
            "grads": {**ad0, "blocks": grads},
            "full": (float(full_loss),
                     convert.dit_from_jax(_as_np(fstate2.params))),
            "full_grads": convert.dit_from_jax(full_grads)}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, jax_side, tmp_path_factory):
    world = request.param
    cases = CASES if world == 4 else tuple(c for c in CASES
                                           if c != "lora_data_seq")
    return world, run_world(world, tmp_path_factory.mktemp("train"), cases,
                            jax_side["payload"])


def _assert_step(got, want_loss, grads, w0, w1, atol=1e-2 * LR):
    """The loss, the gradients AdamW took and every trained tensor's move
    (where the gradient is well clear of its tolerance, within ``atol``)
    against the wanted ones ({name: array})."""
    np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-5)
    gmax = max(float(np.abs(v).max()) for v in grads.values())
    moved = 0.0
    for k, v in got["trained"].items():
        np.testing.assert_allclose(got["grads"][k], grads[k], rtol=1e-4,
                                   atol=1e-4 * gmax, err_msg=k)
        sure = np.abs(grads[k]) > 1e-3 * gmax
        np.testing.assert_allclose((v - w0[k])[sure], (w1[k] - w0[k])[sure],
                                   rtol=0, atol=atol, err_msg=k)
        moved = max(moved, float(np.abs(w1[k] - w0[k]).max()))
    assert moved > 0.5 * LR


def _assert_lora_step(got, jax_side):
    """The LoRA step against JAX's sharded step."""
    from videocof_torch import convert
    cfg = jax_side["payload"]["dit_cfg"]
    want_loss, want = jax_side["lora"]

    def port(tree):
        return {k: v.numpy() for k, v in
                convert.lora_from_jax(tree, cfg).state_dict().items()}

    _assert_step(got, want_loss, port(jax_side["grads"]),
                 port(jax_side["ad0"]), port(want))


def test_lora_step_over_data_matches_jax(ranks, jax_side):
    """Data parallel over the world (1 or 2 rows a rank), the frozen base
    FSDP-sharded: the gradients averaged over data."""
    world, res = ranks
    for got in res:
        _assert_lora_step(got["lora_data"], jax_side)


def test_lora_step_over_seq_matches_jax(ranks, jax_side):
    """Ulysses over the world: the gradients summed over seq (each rank's
    backward saw only its tokens), not averaged."""
    world, res = ranks
    for got in res:
        _assert_lora_step(got["lora_seq"], jax_side)


def test_lora_step_over_data_and_seq_matches_jax(jax_side, ranks):
    world, res = ranks
    if world == 2:
        # data 2 x seq 1 is the data case of this world
        res = [{"lora_data_seq": got["lora_data"]} for got in res]
    for got in res:
        _assert_lora_step(got["lora_data_seq"], jax_side)


def test_full_finetune_step_matches_jax(ranks, jax_side):
    """A full fine-tuning step over data 2 x seq world/2 (parameters and
    AdamW moments FSDP-sharded), gathered whole after the step, against
    JAX's FSDP step."""
    world, res = ranks
    want_loss, want = jax_side["full"]
    before = {k: v.numpy() for k, v in jax_side["payload"]["dit"].items()}
    want = {k: v.numpy() for k, v in want.items()}
    grads = {k: v.numpy() for k, v in jax_side["full_grads"].items()}
    for got in res:
        out = got["full_data"]
        assert out["n_sharded"] > 0
        assert set(out["trained"]) == set(want)
        _assert_step(out, want_loss, grads, before, want, atol=2e-2 * LR)


# ---------------------------------------------------------------- trainer

def test_trainer_timestep_bands(jax_side):
    """The trainer's draw with 2 bands over a batch of 2: row d within
    JAX's band d (`DiscreteSampling`), where JAX's one-process trainer
    draws every row from band 0 (ROADMAP.md §A, the stated departure)."""
    from videocof_tpu.training import timestep_sampler as jts
    from _torch_parallel_ranks import _trainer
    tr = _trainer(jax_side["payload"], bands=2)
    drawn = np.stack([tr.draw_timesteps().numpy() for _ in range(400)])
    js = jts.DiscreteSampling(2)
    for d in range(2):
        lo = d * js.band
        hi = js.num_train_timesteps if d == 1 else lo + js.band
        assert lo <= drawn[:, d].min() and drawn[:, d].max() < hi
        assert drawn[:, d].max() - drawn[:, d].min() > 0.9 * (hi - lo)


def test_trainer_over_data_splits_rows_and_bands(ranks):
    """`CoFTrainer(mesh_data=2, mesh_seq=world/2, batch_size=2)`: data rank
    d prepares row d of the global batch (its seq ranks the same row),
    every rank draws the same timesteps, row d from band d of 2, and the
    state saves (rank 0 writes)."""
    world, res = ranks
    drawn = res[0]["trainer"]["timesteps"][0]
    assert 0 <= drawn[0] < 500 <= drawn[1] < 1000
    for r, got in enumerate(res):
        out = got["trainer"]
        np.testing.assert_array_equal(out["timesteps"][0], drawn)
        assert out["rows"] == [[f"item {r // (world // 2)}"]]
        assert out["saved"]


def test_trainer_over_data_matches_one_process(ranks, jax_side):
    """The data-parallel trainer's first loss and adapters against the
    one-process trainer on the same two samples with a sampler of 2 bands
    (the same draws)."""
    from _torch_parallel_ranks import _np, _samples, _trainer, record_grads
    world, res = ranks
    p = jax_side["payload"]
    one = _trainer(p, bands=2)
    w0 = {k: _np(v) for k, v in one.state.adapters.state_dict().items()}
    grads = record_grads(one.state)
    one.train(_samples(p), total_steps=1)
    w1 = {k: _np(v) for k, v in one.state.adapters.state_dict().items()}
    for got in res:
        _assert_step(got["trainer"], one.losses[0], grads, w0, w1)


def test_trainer_with_umt5_offloaded_matches_resident(jax_side):
    """``offload_t5`` (umT5 in host memory, run on transient device copies
    while a batch is prepared) trains as the resident encoder does."""
    from _torch_parallel_ranks import _np, _samples, _trainer
    p = jax_side["payload"]
    runs = []
    for offload in (False, True):
        tr = _trainer(p, offload_t5=offload)
        tr.train(_samples(p), total_steps=1)
        runs.append((tr.losses[0], {k: _np(v) for k, v in
                                    tr.state.adapters.state_dict().items()}))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        np.testing.assert_array_equal(runs[1][1][k], v, err_msg=k)
