"""The family loaders of both packages on one diffusers-layout directory per
family, written by the port's `save_family_checkpoint_dir` (a
``transformer/`` and a ``vae/`` each holding a ``config.json`` with its
``_class_name`` and safetensors whose keys are the ones JAX's converters
read): `factory.load_family_pipeline` in each package, their pipelines run
on the same embeddings and starting latents, the outputs compared (2e-4,
the pipelines' tolerance); the bare transformer directories of the image
families (latents out); `load_pipeline` routing a family directory; and
``quantize="fp8"`` against JAX's `quantize_params_fp8` with each family's
exclusions, bit for bit."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videocof_tpu import factory as jfactory
from videocof_torch import convert, factory
from videocof_torch.utils import checkpoint
from videocof_torch.utils.fp8 import is_fp8

from _family_models import (J_FLUX, J_QWEN, cogvideox,
                            cogvideox_vae, flux, jax_latents, kl, qwen_vae,
                            qwenimage, text)

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
HW = dict(height=32, width=32)


def _write(tmp_path, family, with_vae=True, layout="5b"):
    """A pipeline directory of ``family`` on the test weights."""
    dit = {"cogvideox": lambda: cogvideox(layout)[1],
           "flux": lambda: flux(True)[1],
           "qwenimage": lambda: qwenimage()[1]}[family]()
    vae = None
    if with_vae:
        vae = {"cogvideox": cogvideox_vae, "flux": kl,
               "qwenimage": qwen_vae}[family]()[1]
    return checkpoint.save_family_checkpoint_dir(
        str(tmp_path / f"{family}_{layout}"), dit, vae)


def _run(family, pipe, layout="5b"):
    """One call of a family pipeline (either package's) on fixed inputs."""
    if family == "cogvideox":
        kw = dict(height=32, width=48, num_frames=9, num_inference_steps=2,
                  seed=3)
        if hasattr(pipe, "dit"):
            kw["latents"] = jax_latents(3, (1, 3, 4, 4, 6))
        return pipe(text(0, 1, 8, 32), text(1, 1, 8, 32), **kw)
    if family == "flux":
        cfg = J_FLUX[True]
        kw = dict(num_inference_steps=2, seed=9, **HW)
        if hasattr(pipe, "dit"):
            kw["latents"] = jax_latents(9, (1, cfg.in_channels // 4, 4, 4))
        return pipe(text(4, 1, 6, cfg.joint_attention_dim),
                    text(5, 1, 1, cfg.pooled_projection_dim)[:, 0], **kw)
    kw = dict(num_inference_steps=2, seed=7, **HW)
    if hasattr(pipe, "dit"):
        kw["latents"] = jax_latents(7, (1, J_QWEN.in_channels // 4, 4, 4))
    return pipe(text(2, 1, 6, J_QWEN.joint_attention_dim),
                text(3, 1, 6, J_QWEN.joint_attention_dim), **kw)


@pytest.mark.parametrize("family,layout,with_vae", [
    ("cogvideox", "2b", True), ("cogvideox", "5b", True),
    ("flux", "5b", True), ("qwenimage", "5b", True),
    ("flux", "5b", False), ("qwenimage", "5b", False)])
def test_both_loaders_give_the_same_outputs(tmp_path, monkeypatch, family,
                                            layout, with_vae):
    """QwenImage's VAE is read at a fixed config in both packages
    (`QWENIMAGE_VAE_CONFIG`, the Wan2.1 VAE's): the tiny one stands in for
    it in both here."""
    import videocof_tpu.models.qwenimage_vae as jqvae
    from videocof_torch.models import qwenimage_vae
    from _family_models import J_QVAE, QVAE
    monkeypatch.setattr(jqvae, "QWENIMAGE_VAE_CONFIG", J_QVAE)
    monkeypatch.setattr(qwenimage_vae, "QWENIMAGE_VAE_CONFIG", QVAE)
    path = _write(tmp_path, family, with_vae, layout)
    with open(f"{path}/transformer/config.json") as f:
        assert json.load(f)["_class_name"] == {
            "cogvideox": "CogVideoXTransformer3DModel",
            "flux": "FluxTransformer2DModel",
            "qwenimage": "QwenImageTransformer2DModel"}[family]
    if not with_vae:              # the bare transformer directory
        path = f"{path}/transformer"
    assert factory.detect_family(path) == jfactory.detect_family(path) \
        == family
    jpipe = jfactory.load_family_pipeline(path, dtype=jnp.float32)
    pipe = factory.load_family_pipeline(path, dtype=torch.float32,
                                        device="cpu")
    assert type(pipe).__name__ == type(jpipe).__name__
    got, want = _run(family, pipe, layout), _run(family, jpipe, layout)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_load_pipeline_routes_a_family_directory(tmp_path):
    path = _write(tmp_path, "flux")
    pipe = factory.load_pipeline(path, dtype=torch.float32, device="cpu")
    jpipe = jfactory.load_pipeline(path, dtype=jnp.float32)
    assert type(pipe).__name__ == type(jpipe).__name__ == "FluxPipeline"


def test_cogvideox_without_vae_raises(tmp_path):
    path = _write(tmp_path, "cogvideox", with_vae=False)
    for load in (lambda: jfactory.load_family_pipeline(path),
                 lambda: factory.load_family_pipeline(path, device="cpu")):
        with pytest.raises(ValueError, match="vae"):
            load()


def _assert_fp8_matches(dit, qtree):
    """Every linear of ``dit`` fp8 exactly where JAX's leaf is, in the same
    fp8 bits and scale (per layer for the stacked blocks)."""
    n_fp8 = 0
    for name, mod in dit.named_modules():
        if not isinstance(mod, torch.nn.Linear):
            continue
        path = convert.jax_param_path(name + ".weight").split("/")
        node = qtree
        for p in path:
            node = node[p]
        assert is_fp8(mod) == isinstance(node, dict), name
        if not is_fp8(mod):
            continue
        q = np.asarray(node["fp8"])
        s = np.asarray(node["scale"], np.float32)
        if path[0] in ("blocks", "single_blocks"):
            i = int(name.split(".")[1])
            q, s = q[i], s[i]
        np.testing.assert_array_equal(mod.weight.view(torch.uint8).numpy(),
                                      np.swapaxes(q, -1, -2).view(np.uint8))
        assert mod.weight_scale.numpy().tobytes() == s.tobytes(), name
        n_fp8 += 1
    return n_fp8


@pytest.mark.parametrize("family,want_fp8", [
    # CogVideoX with JAX's default exclusions: per block q, k, v, o, fc1,
    # fc2 (its AdaLN linears sit under 'norm'), plus the patch, text and
    # output projections
    ("cogvideox", 6 * 2 + 3),
    # Flux: its AdaLN linears quantized (14 a double block, 6 a single one,
    # with the embedders x and context and proj_out)
    # (``context_embedder`` holds 'text_embed': it stays, in both)
    ("flux", 14 * 2 + 6 * 2 + 2),
    # QwenImage: 14 a block (img_mod and txt_mod included) and img_in,
    # txt_in, proj_out
    ("qwenimage", 14 * 2 + 3)])
def test_fp8_load_matches_jax_quantization(tmp_path, family, want_fp8):
    cog = family == "cogvideox"       # CogVideoX's directory needs its VAE
    path = _write(tmp_path, family, with_vae=cog)
    path = path if cog else f"{path}/transformer"
    jpipe = jfactory.load_family_pipeline(path, dtype=jnp.bfloat16,
                                          quantize="fp8")
    pipe = factory.load_family_pipeline(path, dtype=torch.bfloat16,
                                        quantize="fp8", device="cpu")
    assert _assert_fp8_matches(pipe.dit, jpipe.dit_params) == want_fp8
