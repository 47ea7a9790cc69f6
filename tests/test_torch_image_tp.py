"""Tensor parallelism of the non-Wan families in the port against the JAX
package's, as `tests/test_image_tp.py` holds JAX's: CogVideoX (both
layouts), Flux (double and single blocks) and QwenImage (with a ragged
text mask) with their parameters cut by `parallel.apply_tp` and
`make_tp_attention` as the attention, at tp 2 (a world of 2) and tp 4 (a
world of 4), and Flux and QwenImage at tp 2 x Ulysses seq 2 at stream
lengths that divide no seq axis; the AdaLN linears' column shards, the
per-head norms whole, and the split rows of Flux's single-block
``proj_out``.

The port runs in gloo worlds of 2 and 4 CPU processes
(`_torch_parallel_ranks.run_world`), JAX in this process on the 8-device
virtual CPU mesh (`tests/conftest.py`), its parameters placed with
`tp_param_shardings`. Same weights (`videocof_torch.convert`) and inputs,
float32; tolerance 2e-4 (JAX's `test_image_tp.py`).
"""

import numpy as np
import pytest
import torch

from _torch_parallel_ranks import run_world

torch.set_num_threads(1)

WORLDS = (2, 4)
TOL = dict(rtol=2e-4, atol=2e-4)
FAMILIES = ("cogvideox_2b", "cogvideox_5b", "flux", "qwenimage")


@pytest.fixture(scope="module")
def jax_side():
    """JAX's forwards (unsharded, tp 2, tp 4, tp 2 x seq 2) and the payload
    the ranks take."""
    import jax
    import jax.numpy as jnp
    from videocof_tpu.models import cogvideox as jcog
    from videocof_tpu.models import flux as jflux
    from videocof_tpu.models import qwenimage as jqwen
    from videocof_tpu.parallel import (SPContext, make_mesh,
                                       make_tp_attention,
                                       tp_param_shardings)
    import _family_models as fm

    rng = np.random.default_rng(0)
    payload, want = {"families": {}}, {}

    def add(name, family, jcfg, module, params, fwd, args, kw, seq2):
        jargs = [jnp.asarray(a) for a in args]
        jkw = {k: jnp.asarray(v) for k, v in kw.items()}
        out = {"base": np.asarray(fwd(params, jcfg, *jargs, **jkw))}
        layouts = {"tp2": (1, 1, 2), "tp4": (1, 1, 4)}
        if seq2:
            layouts["tp2_seq2"] = (1, 2, 2)
        for lname, shape in layouts.items():
            mesh = make_mesh(*shape)
            sharded = jax.device_put(params, tp_param_shardings(mesh,
                                                                params))
            seq = shape[1] > 1
            attn = make_tp_attention(mesh, seq_axis="seq" if seq else None)
            sp = SPContext(mesh) if seq else None
            out[lname] = np.asarray(jax.jit(lambda p, *a: fwd(
                p, jcfg, *a, attn_backend=attn, sp=sp, **jkw))(
                sharded, *jargs))
        want[name] = out
        payload["families"][name] = dict(family=family, cfg=module.cfg,
                                         sd=module.state_dict(), args=args,
                                         kw=kw)

    for layout in ("2b", "5b"):
        p, m = fm.cogvideox(layout)
        x = rng.standard_normal((1, 2, 4, 6, 6)).astype(np.float32)
        txt = rng.standard_normal((1, 7, 32)).astype(np.float32)
        add(f"cogvideox_{layout}", "cogvideox", fm.J_COG[layout], m,
            fm.on_device(p), jcog.cogvideox_forward,
            [x, txt, np.array([500.0], np.float32)], {}, False)

    fcfg = jflux.FLUX_TINY.replace(guidance_embeds=True)
    p, m = fm.flux(True, cfg=fcfg)
    Li, Lt = 15, 7
    img = rng.standard_normal((1, Li, 8)).astype(np.float32)
    txt = rng.standard_normal((1, Lt, 32)).astype(np.float32)
    pooled = rng.standard_normal((1, 16)).astype(np.float32)
    iids = np.stack([np.zeros(Li), np.arange(Li) // 5, np.arange(Li) % 5],
                    -1).astype(np.float32)
    tids = np.zeros((Lt, 3), np.float32)
    add("flux", "flux", fcfg, m, fm.on_device(p),
        lambda prm, c, *a, **k: jflux.flux_forward(prm, c, *a[:6],
                                                    guidance=a[6], **k),
        [img, txt, pooled, np.array([0.7], np.float32), iids, tids,
         np.array([3.5], np.float32)], {}, True)

    qcfg = jqwen.QWENIMAGE_TINY
    p, m = fm.qwenimage(cfg=qcfg)
    img = rng.standard_normal((2, 9, qcfg.in_channels)).astype(np.float32)
    txt = rng.standard_normal((2, 5, 32)).astype(np.float32)
    ii, ti = (np.asarray(a) for a in jqwen.qwen_position_ids((1, 3, 3), 5))
    mask = np.array([[1, 1, 1, 0, 0], [1] * 5], bool)
    add("qwenimage", "qwenimage", qcfg, m, fm.on_device(p),
        jqwen.qwenimage_forward,
        [img, txt, np.array([0.7, 0.2], np.float32), ii, ti],
        {"encoder_hidden_states_mask": mask}, True)
    return want, payload


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, jax_side, tmp_path_factory):
    world = request.param
    return world, run_world(world, tmp_path_factory.mktemp("image_tp"),
                            ("image_tp",), jax_side[1])


@pytest.mark.parametrize("name", FAMILIES)
def test_family_tp_forward_matches_jax(ranks, jax_side, name):
    """tp = world: every rank's output against JAX's TP forward over the
    same degree and its unsharded forward (held together first)."""
    world, res = ranks
    want = jax_side[0][name]
    lname = f"tp{world}"
    np.testing.assert_allclose(want[lname], want["base"], **TOL)
    for r, got in enumerate(res):
        out = got["image_tp"][(name, "tp")]
        np.testing.assert_allclose(out, want[lname], **TOL,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(out, want["base"], **TOL)


@pytest.mark.parametrize("name", ["flux", "qwenimage"])
def test_family_tp_sp_forward_matches_jax(ranks, jax_side, name):
    """tp 2 x Ulysses seq 2 (heads and tokens both cut; each stream padded
    to the seq axis, the pad keys masked): every rank against JAX's."""
    world, res = ranks
    if world == 2:
        pytest.skip("tp 2 x seq 2 needs a world of 4")
    want = jax_side[0][name]
    np.testing.assert_allclose(want["tp2_seq2"], want["base"], **TOL)
    for got in res:
        out = got["image_tp"][(name, "tp2_seq2")]
        np.testing.assert_allclose(out, want["tp2_seq2"], **TOL)
        np.testing.assert_allclose(out, want["base"], **TOL)


def test_flux_shards(ranks, jax_side):
    """Flux's shards at tp = world: the attention and MLP column/row cuts,
    the AdaLN ``lin`` columns (6d/tp and 3d/tp), the per-head RMS weights
    and the head whole; the single-block ``proj_out`` keeps the rows of
    this rank's attention features and MLP features, [r d/tp, (r+1) d/tp)
    and [d + r 4d/tp, d + (r+1) 4d/tp)."""
    world, res = ranks
    entry = jax_side[1]["families"]["flux"]
    full = entry["sd"]["single_blocks.0.proj_out.weight"].numpy()
    d = entry["cfg"].inner_dim
    hd = entry["cfg"].attention_head_dim
    a, m = d // world, 4 * d // world
    want = {"blocks.0.attn.add_v.weight": (a, d),
            "blocks.0.attn.o.weight": (d, a),
            "blocks.0.attn.o.bias": (d,),
            "blocks.0.ff_context.fc1.weight": (m, d),
            "blocks.0.norm1.lin.weight": (6 * d // world, d),
            "blocks.0.attn.norm_q.weight": (hd,),
            "single_blocks.0.proj_mlp.weight": (m, d),
            "single_blocks.0.proj_out.weight": (d, 5 * d // world),
            "single_blocks.0.proj_out.bias": (d,),
            "single_blocks.0.norm.lin.weight": (3 * d // world, d),
            "proj_out.weight": tuple(entry["sd"]["proj_out.weight"].shape)}
    for r, got in enumerate(res):
        shapes = got["image_tp"]["flux_shapes"]
        for k, v in want.items():
            assert shapes[k] == v, k
        rows = np.concatenate([full[:, r * a:(r + 1) * a],
                               full[:, d + r * m:d + (r + 1) * m]], axis=1)
        np.testing.assert_array_equal(got["image_tp"]["flux_proj_out"],
                                      rows)
