"""Pipeline (GPipe) and expert parallelism in the port against the JAX
package's: `pp_scan_blocks` over S = 2 and 4 stages at 1, 2 and 4
microbatches against JAX's and the sequential blocks, its gradient
(this stage's blocks', the input's and the conditioning's) against the
sequential blocks' (`test_pp_is_differentiable`), the stage each rank
holds; and `select_expert` materializing each expert on every rank bit for
bit from its owner, in fp32 and fp8, with JAX's `stack_experts` tree
carried by `convert.experts_from_jax`.

The port runs in gloo worlds of 2 and 4 CPU processes
(`_torch_parallel_ranks.run_world`: S = world stages; the experts one a
rank of a data axis of 2); JAX in this process on the 8-device virtual CPU
mesh. Same weights and inputs, float32; tolerance 1e-4 for the outputs
(1e-4 of the largest value for the gradients).
"""

import numpy as np
import pytest
import torch

from _torch_parallel_ranks import run_world

torch.set_num_threads(1)

WORLDS = (2, 4)
TOL = dict(rtol=1e-4, atol=1e-4)
MICRO = (1, 2, 4)


def _as_np(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_side():
    """JAX's pipelined and sequential blocks, their gradients, its expert
    selection, and the payload the ranks take."""
    import jax
    import jax.numpy as jnp
    from videocof_tpu.configs import WanDiTConfig as JCfg
    from videocof_tpu.models import wan_dit as jdit
    from videocof_tpu.parallel import (make_mesh, select_expert,
                                       stack_experts)
    from videocof_tpu.parallel.pp import pp_param_shardings, pp_scan_blocks
    from videocof_torch import convert
    from videocof_torch.configs import WanDiTConfig

    cfg = JCfg(dim=64, ffn_dim=128, num_heads=4, num_layers=4, text_dim=32,
               text_len=16, freq_dim=32)
    keys = jax.random.split(jax.random.PRNGKey(0), cfg.num_layers)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        jdit.init_block_params(k, cfg, jnp.float32) for k in keys])
    B, L = 4, 24
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, L, cfg.dim)).astype(np.float32)
    e0 = rng.standard_normal((B, 6, cfg.dim)).astype(np.float32)
    ctx = rng.standard_normal((B, cfg.text_len, cfg.dim)).astype(np.float32)
    cos, sin = jdit.make_rope_for_geometry(cfg, (6, 2, 2))
    rope = (jnp.asarray(cos), jnp.asarray(sin))

    def block_fn(bp, h, cond):
        return jdit.wan_block_apply(bp, cfg, h, cond[0], cond[1], rope)

    def seq_fn(params, h, ce0):
        h, _ = jax.lax.scan(
            lambda c, bp: (block_fn(bp, c, (ce0, jnp.asarray(ctx))), None),
            h, params)
        return h

    jx, je0, jctx = jnp.asarray(x), jnp.asarray(e0), jnp.asarray(ctx)
    want = {"seq": np.asarray(seq_fn(stacked, jx, je0))}
    for S in WORLDS:
        mesh = make_mesh(seq=S)
        sharded = jax.device_put(stacked, pp_param_shardings(mesh, stacked))
        for M in MICRO:
            want[(S, M)] = np.asarray(jax.jit(
                lambda p, h: pp_scan_blocks(mesh, block_fn, p, h,
                                            (je0, jctx), microbatches=M))(
                sharded, jx))
    gp, gx, ge0 = jax.grad(lambda p, h, c: jnp.sum(seq_fn(p, h, c) ** 2),
                           argnums=(0, 1, 2))(stacked, jx, je0)
    grads = {k: v.numpy() for k, v in
             convert.dit_from_jax({"blocks": _as_np(gp)}).items()}

    # two experts (tiny DiTs), JAX's stack and its selection's forward
    dcfg = cfg.replace(num_layers=2)
    experts = [jdit.init_wan_dit(jax.random.PRNGKey(s), dcfg)
               for s in (1, 5)]
    jstack = stack_experts(*experts)
    f, h, w = 3, 2, 2
    dit_in = [rng.standard_normal((1, dcfg.in_dim, f, 2 * h, 2 * w)
                                  ).astype(np.float32),
              np.array([500.0], np.float32),
              rng.standard_normal((1, dcfg.text_len, dcfg.text_dim)
                                  ).astype(np.float32),
              *(np.asarray(a, np.float32)
                for a in jdit.make_rope_for_geometry(dcfg, (f, h, w)))]
    ep_want = [np.asarray(jdit.wan_dit_forward(
        select_expert(jstack, k), dcfg, *[jnp.asarray(a) for a in dit_in]))
        for k in (0, 1)]

    blocks = convert.dit_from_jax({"blocks": _as_np(stacked)})
    payload = {
        "pp_cfg": convert.config_from(WanDiTConfig, cfg),
        "pp_blocks": [{k.split(".", 2)[2]: v for k, v in blocks.items()
                       if k.startswith(f"blocks.{i}.")}
                      for i in range(cfg.num_layers)],
        "pp_in": {"x": x, "e0": e0, "ctx": ctx},
        "pp_rope": (np.asarray(cos, np.float32),
                    np.asarray(sin, np.float32)),
        "tp_dit_cfg": convert.config_from(WanDiTConfig, dcfg),
        "tp_dit": convert.dit_from_jax(_as_np(experts[0])),
        "dit_b": convert.dit_from_jax(_as_np(experts[1])),
        "tp_in": dit_in,
    }
    return {"want": want, "grads": grads, "gx": np.asarray(gx),
            "ge0": np.asarray(ge0), "ep_want": ep_want,
            "jstack": _as_np(jstack), "payload": payload}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, jax_side, tmp_path_factory):
    world = request.param
    return world, run_world(world, tmp_path_factory.mktemp("pp"),
                            ("pp", "ep"), jax_side["payload"])


@pytest.mark.parametrize("microbatches", MICRO)
def test_pp_matches_jax_and_sequential(ranks, jax_side, microbatches):
    """S = world stages, M microbatches of a batch of 4: every rank's
    output against JAX's `pp_scan_blocks` over the same S and M, and
    against the sequential blocks."""
    world, res = ranks
    want = jax_side["want"]
    np.testing.assert_allclose(want[(world, microbatches)], want["seq"],
                               **TOL)
    for r, got in enumerate(res):
        out = got["pp"][microbatches]
        np.testing.assert_allclose(out, want[(world, microbatches)], **TOL,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(out, want["seq"], **TOL)


def test_pp_weights_are_stage_sharded(ranks):
    """Stage s holds the contiguous blocks [s n/S, (s+1) n/S)."""
    world, res = ranks
    per = 4 // world
    for s, got in enumerate(res):
        assert got["pp"]["stage_ids"] == list(range(s * per, (s + 1) * per))


def test_pp_is_differentiable(ranks, jax_side):
    """The gradient of sum(out^2) through the schedule (M = 2): each
    stage's block parameters, the input's and the conditioning's (e0,
    every stage's share summed) against JAX's through the sequential
    blocks."""
    world, res = ranks
    g = jax_side["grads"]
    gmax = max(float(np.abs(v).max()) for v in g.values())
    for got in res:
        pp = got["pp"]
        assert len(pp["grads"]) == len(g) // world
        for k, v in pp["grads"].items():
            np.testing.assert_allclose(v, g[f"blocks.{k}"],
                                       rtol=1e-4, atol=1e-4 * gmax,
                                       err_msg=k)
        for name, want in (("grad_x", jax_side["gx"]),
                           ("grad_e0", jax_side["ge0"])):
            np.testing.assert_allclose(pp[name], want, rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("kind", ["fp32", "fp8"])
def test_select_expert_is_the_owners_bit_for_bit(ranks, kind):
    """Two experts, one a rank of a data axis of 2: `select_expert(k)`
    gives every rank expert k's tensors bit for bit (fp8 weights and
    their scales moved as bytes), and its forward through a shell on the
    meta device equals the owner's own forward bit for bit."""
    world, res = ranks
    owners = {got["ep"]["owner"]: got["ep"][(kind, "own")] for got in res}
    assert set(owners) == {0, 1}
    for got in res:
        ep = got["ep"]
        assert ep[(kind, "local_lead")] == 1
        for k in (0, 1):
            assert ep[(kind, "same_bytes", k)]
            np.testing.assert_array_equal(ep[(kind, k)], owners[k])


def test_select_expert_matches_jax(ranks, jax_side):
    """The selected fp32 expert's forward against JAX's `select_expert` of
    its `stack_experts` tree, and that tree carried by
    `convert.experts_from_jax` equal to the port's stack."""
    from _torch_parallel_ranks import _dit
    from videocof_torch import convert
    from videocof_torch.parallel import stack_experts
    world, res = ranks
    p = jax_side["payload"]
    for got in res:
        for k in (0, 1):
            np.testing.assert_allclose(got["ep"][("fp32", k)],
                                       jax_side["ep_want"][k], **TOL)
    mine = stack_experts(*(_dit(p[n], p["tp_dit_cfg"])
                           for n in ("tp_dit", "dit_b")))
    carried = convert.experts_from_jax(jax_side["jstack"])
    assert set(carried) == set(mine)
    for k, v in mine.items():
        assert torch.equal(carried[k], v), k
