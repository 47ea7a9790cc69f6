"""The port's XLM-Roberta text tower (`models/xlm_roberta.py`) against the
JAX package's at `XLMR_TINY`: the hidden states and the pooled CLIP text
embedding on ragged prompts, within 1e-5 in float32 on the same weights
(`convert.xlm_roberta_from_jax`); the reference checkpoint's keys read by
`convert_xlm_roberta_state_dict` as JAX's converter reads them, under a
prefix too; the random init's draw."""

import numpy as np
import pytest
import torch

from videocof_torch import convert
from videocof_torch.models import xlm_roberta as xr

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def both():
    import jax
    from videocof_tpu.models import xlm_roberta as jxr
    params = jax.tree.map(np.asarray, jxr.init_xlm_roberta(
        jax.random.PRNGKey(0), jxr.XLMR_TINY))
    model = xr.XLMRoberta(xr.XLMR_TINY)
    model.load_state_dict(convert.xlm_roberta_from_jax(params))
    rng = np.random.default_rng(7)
    ids = rng.integers(2, xr.XLMR_TINY.vocab_size, (2, 12)).astype(np.int32)
    ids[0, 8:] = xr.XLMR_TINY.pad_id       # ragged: the mask and positions
    return params, model, ids


def _reference_keys(params, prefix=""):
    """The JAX tree written in the reference module's keys (the inverse of
    JAX's converter)."""
    sd = {}
    for n in ("token", "type", "pos"):
        sd[f"{n}_embedding.weight"] = params[f"{n}_embedding"]
    sd["norm.weight"], sd["norm.bias"] = (params["norm"]["scale"],
                                          params["norm"]["bias"])
    for i, b in enumerate(params["blocks"]):
        for n in "qkvo":
            sd[f"blocks.{i}.attn.{n}.weight"] = b["attn"][n]["kernel"].T
            sd[f"blocks.{i}.attn.{n}.bias"] = b["attn"][n]["bias"]
        for dst, src in (("norm1", "norm1"), ("norm2", "norm2")):
            sd[f"blocks.{i}.{dst}.weight"] = b[src]["scale"]
            sd[f"blocks.{i}.{dst}.bias"] = b[src]["bias"]
        for dst, src in (("ffn.0", "fc1"), ("ffn.2", "fc2")):
            sd[f"blocks.{i}.{dst}.weight"] = b[src]["kernel"].T
            sd[f"blocks.{i}.{dst}.bias"] = b[src]["bias"]
    sd["head.0.weight"] = params["head"]["fc1"]["kernel"].T
    sd["head.2.weight"] = params["head"]["fc2"]["kernel"].T
    return {prefix + k: np.ascontiguousarray(v) for k, v in sd.items()}


def test_encode_matches_jax(both):
    import jax.numpy as jnp
    from videocof_tpu.models import xlm_roberta as jxr
    params, model, ids = both
    want = np.asarray(jxr.xlm_roberta_encode(
        jax_tree(params), jxr.XLMR_TINY, jnp.asarray(ids)))
    with torch.no_grad():
        got = xr.xlm_roberta_encode(model, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_clip_text_matches_jax(both):
    import jax.numpy as jnp
    from videocof_tpu.models import xlm_roberta as jxr
    params, model, ids = both
    want = np.asarray(jxr.xlm_roberta_clip_text(
        jax_tree(params), jxr.XLMR_TINY, jnp.asarray(ids)))
    with torch.no_grad():
        got = xr.xlm_roberta_clip_text(model, torch.from_numpy(ids)).numpy()
    assert got.shape == (2, xr.XLMR_TINY.out_dim)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("prefix", ["", "textual."])
def test_checkpoint_keys_convert_as_jax(both, prefix):
    """The reference's keys (under ``textual.`` inside the CLIP file) give
    the port's state dict that JAX's converter's tree carries to."""
    from videocof_tpu.models import xlm_roberta as jxr
    params, model, _ = both
    sd = _reference_keys(params, prefix)
    want = convert.xlm_roberta_from_jax(jxr.convert_xlm_roberta_state_dict(
        sd, jxr.XLMR_TINY, prefix=prefix))
    got = xr.convert_xlm_roberta_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, xr.XLMR_TINY,
        prefix=prefix)
    assert set(got) == set(want) == set(model.state_dict())
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_init_draws_as_jax():
    """`init_xlm_roberta`: N(0, 0.02^2) embeddings, uniform linear weights
    within 1/sqrt(din), zero biases, unit norms; the encoder runs."""
    model = xr.init_xlm_roberta(xr.XLMR_TINY, torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert 0.015 < float(sd["token_embedding"].std()) < 0.025
    w = sd["blocks.0.fc1.weight"]
    bound = 1 / np.sqrt(w.shape[1])
    assert 0.9 * bound < float(w.abs().max()) <= bound * (1 + 1e-6)
    assert float(sd["blocks.0.fc1.bias"].abs().max()) == 0.0
    assert torch.equal(sd["norm.scale"], torch.ones_like(sd["norm.scale"]))
    ids = torch.tensor([[5, 6, 7, 1]])
    with torch.no_grad():
        out = xr.xlm_roberta_clip_text(model, ids)
    assert out.shape == (1, xr.XLMR_TINY.out_dim)
    assert torch.isfinite(out).all()


def jax_tree(params):
    import jax
    import jax.numpy as jnp
    return jax.tree.map(jnp.asarray, params)
