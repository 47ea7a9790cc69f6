"""Sequence parallelism of the non-Wan families in the port against the JAX
package's mesh, as `tests/test_image_sp.py` holds JAX's: the port in a gloo
world of 2 CPU processes (`_torch_parallel_ranks.run_world`, each rank
holding only its shards, Ulysses and ring), JAX in this process on 2 of the
8 virtual CPU devices (`tests/conftest.py`) under its Ulysses attention.
CogVideoX in both layouts, Flux and QwenImage (with a ragged text mask),
each at stream lengths that divide no seq axis (the per-stream padding and
the joint key mask), and the Flux pipeline with `enable_sequence_parallel`.
Same weights (`videocof_torch.convert`), inputs and start latents, float32;
tolerance 1e-4 for the forwards (`test_torch_parallel.py`'s DiT bound) and
2e-4 for the pipeline."""

import numpy as np
import pytest
import torch

from _torch_parallel_ranks import run_world

torch.set_num_threads(1)

WORLD = 2
FWD_TOL = dict(rtol=1e-4, atol=1e-4)
PIPE_TOL = dict(rtol=2e-4, atol=2e-4)
FAMILIES = ("cogvideox_2b", "cogvideox_5b", "flux", "qwenimage")


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(JAX's outputs, the port's ranks' results) of one spawn."""
    import jax
    import jax.numpy as jnp
    from videocof_tpu.models import cogvideox as jcog
    from videocof_tpu.models import flux as jflux
    from videocof_tpu.models import qwenimage as jqwen
    from videocof_tpu.parallel import (SPContext, make_mesh,
                                       make_ulysses_attention)
    from videocof_tpu.pipeline.image_pipelines import FluxPipeline as JFlux
    import _family_models as fm

    rng = np.random.default_rng(0)
    mesh = make_mesh(data=1, seq=WORLD)
    backend, sp = make_ulysses_attention(mesh), SPContext(mesh)
    payload, want = {"families": {}}, {}

    def add(name, family, jcfg, cfg, params, sd, fwd, args, kw):
        """JAX's SP forward and its one-device forward (held together
        first), and the port's entry."""
        jargs = [jnp.asarray(a) for a in args]
        jkw = {k: jnp.asarray(v) for k, v in kw.items()}
        base = np.asarray(fwd(params, jcfg, *jargs, **jkw))
        out = np.asarray(jax.jit(lambda p, *a: fwd(
            p, jcfg, *a, attn_backend=backend, sp=sp, **jkw))(
            params, *jargs))
        np.testing.assert_allclose(out, base, **FWD_TOL)
        want[name] = out
        payload["families"][name] = dict(family=family, cfg=cfg, sd=sd,
                                         args=args, kw=kw)

    for layout in ("2b", "5b"):
        p, m = fm.cogvideox(layout)
        x = rng.standard_normal((1, 2, 4, 6, 6)).astype(np.float32)
        txt = rng.standard_normal((1, 7, 32)).astype(np.float32)
        add(f"cogvideox_{layout}", "cogvideox", fm.J_COG[layout], m.cfg,
            fm.on_device(p), m.state_dict(), jcog.cogvideox_forward,
            [x, txt, np.array([500.0], np.float32)], {})

    fcfg = jflux.FLUX_TINY.replace(guidance_embeds=True)
    p, m = fm.flux(True, cfg=fcfg)
    Li, Lt = 15, 7
    img = rng.standard_normal((1, Li, 8)).astype(np.float32)
    txt = rng.standard_normal((1, Lt, 32)).astype(np.float32)
    pooled = rng.standard_normal((1, 16)).astype(np.float32)
    iids = np.stack([np.zeros(Li), np.arange(Li) // 5, np.arange(Li) % 5],
                    -1).astype(np.float32)
    tids = np.zeros((Lt, 3), np.float32)
    add("flux", "flux", fcfg, m.cfg, fm.on_device(p), m.state_dict(),
        lambda prm, c, *a, **k: jflux.flux_forward(prm, c, *a[:6],
                                                    guidance=a[6], **k),
        [img, txt, pooled, np.array([0.7], np.float32), iids, tids,
         np.array([3.5], np.float32)], {})

    qcfg = jqwen.QWENIMAGE_TINY
    p, m = fm.qwenimage(cfg=qcfg)
    img = rng.standard_normal((2, 9, qcfg.in_channels)).astype(np.float32)
    txt = rng.standard_normal((2, 5, 32)).astype(np.float32)
    ii, ti = (np.asarray(a) for a in jqwen.qwen_position_ids((1, 3, 3), 5))
    mask = np.array([[1, 1, 1, 0, 0], [1] * 5], bool)
    add("qwenimage", "qwenimage", qcfg, m.cfg, fm.on_device(p),
        m.state_dict(), jqwen.qwenimage_forward,
        [img, txt, np.array([0.7, 0.2], np.float32), ii, ti],
        {"encoder_hidden_states_mask": mask})

    # the Flux pipeline under JAX's SP, its start latents for the port
    dp, dit = fm.flux(True)
    jpipe = JFlux(fm.on_device(dp), fm.J_FLUX[True])
    emb = fm.text(4, 1, 6, 32)
    pooled = fm.text(5, 1, 1, 16)[:, 0]
    kw = dict(height=48, width=48, num_inference_steps=2, seed=3)
    jpipe.enable_sequence_parallel(data=1, seq=WORLD)
    want["flux_pipe"] = jpipe(emb, pooled, **kw)
    jpipe.disable_sequence_parallel()
    payload["flux_pipe"] = dict(
        family="flux", cfg=dit.cfg, sd=dit.state_dict(), args=[emb, pooled],
        kw=dict(kw, latents=fm.jax_latents(3, (1, 4, 6, 6))))
    ranks = run_world(WORLD, tmp_path_factory.mktemp("image_sp"),
                      ("family_forwards", "family_pipeline"), payload)
    return want, ranks


@pytest.mark.parametrize("mode", ["ulysses", "ring"])
@pytest.mark.parametrize("name", FAMILIES)
def test_family_forward_sp_matches_jax(both, name, mode):
    want, ranks = both
    for r in ranks:
        np.testing.assert_allclose(r["family_forwards"][(name, mode)],
                                   want[name], **FWD_TOL)


@pytest.mark.parametrize("mode", ["ulysses", "ring"])
def test_flux_pipeline_sp_matches_jax(both, mode):
    want, ranks = both
    for r in ranks:
        got = r["family_pipeline"]
        np.testing.assert_allclose(got[mode], want["flux_pipe"], **PIPE_TOL)
        np.testing.assert_allclose(got["local"], want["flux_pipe"],
                                   **PIPE_TOL)
