"""The port's LoRA adapters against the JAX package's: fusion, the full-tree
apply, the kohya export and its merge, and the DiT forward with the adapters
fused per block. The adapters are drawn by JAX and carried across by
`videocof_torch.convert.lora_from_jax`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videocof_tpu.configs import WAN_TINY as JAX_WAN_TINY
from videocof_tpu.models import lora as jlora
from videocof_tpu.models import wan_dit as jwan_dit
from videocof_torch import convert
from videocof_torch.configs import WanDiTConfig
from videocof_torch.models import lora, wan_dit

torch.set_num_threads(1)

JCFG = JAX_WAN_TINY
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    """JAX base params, the port's DiT with the same weights, and JAX
    adapters with a non-zero ``up`` (rank 4) carried across."""
    params = jwan_dit.init_wan_dit(jax.random.PRNGKey(0), JCFG)
    cfg = convert.config_from(WanDiTConfig, JCFG)
    dit = wan_dit.WanDiT(cfg)
    dit.load_state_dict(convert.dit_from_jax(jax.tree.map(np.asarray, params)))
    ad = jlora.init_lora_adapters(jax.random.PRNGKey(1), JCFG, rank=4)
    rng = np.random.default_rng(2)
    ad["blocks"] = jax.tree.map(
        lambda x: jnp.asarray(0.05 * rng.standard_normal(x.shape), x.dtype)
        + x, ad["blocks"])
    return params, dit, ad, convert.lora_from_jax(ad, cfg)


def test_lora_from_jax_carries_every_adapter(pair):
    _, dit, jad, ad = pair
    assert (ad.rank, ad.alpha) == (4, 4.0)
    for mod, names in jad["blocks"].items():
        for name, a in names.items():
            for i, block in enumerate(ad.blocks):
                for part in ("down", "up"):
                    np.testing.assert_array_equal(
                        getattr(block[mod][name], part).detach().numpy(),
                        np.asarray(a[part][i]))


def test_fuse_and_apply_match_jax(pair):
    params, dit, jad, ad = pair
    scale = ad.scale * 0.7
    jfull = jlora.apply_lora_adapters(params, jad, multiplier=0.7)
    full = lora.apply_lora_adapters(dit, ad, multiplier=0.7)
    for i, block in enumerate(dit.blocks):
        bp = jax.tree.map(lambda x: x[i], params["blocks"])
        bad = jax.tree.map(lambda x: x[i], jad["blocks"])
        jfused = jlora.fuse_block_adapters(bp, bad, scale)
        fused = lora.fuse_block_adapters(block, ad.blocks[i], scale)
        assert len(fused) == 10
        for mod, names in lora.ADAPTER_TARGETS.items():
            for name in names:
                key = f"{mod}.{name}.weight"
                want = np.asarray(jfused[mod][name]["kernel"]).T
                np.testing.assert_allclose(fused[key].detach().numpy(), want,
                                           **TOL)
                np.testing.assert_allclose(
                    full[f"blocks.{i}.{key}"].detach().numpy(),
                    np.asarray(jfull["blocks"][mod][name]["kernel"][i]).T,
                    **TOL)


def test_state_dict_export_matches_jax_and_merges(pair):
    """`lora_adapters_to_state_dict` equals JAX's key for key; JAX's
    `merge_lora` of the port's export equals the port's apply."""
    params, dit, jad, ad = pair
    sd = lora.lora_adapters_to_state_dict(ad)
    jsd = jlora.lora_adapters_to_state_dict(jad)
    assert sorted(sd) == sorted(jsd)
    for key in sd:
        assert sd[key].dtype == np.asarray(jsd[key]).dtype, key
        np.testing.assert_array_equal(sd[key], np.asarray(jsd[key]), key)
    merged = jlora.merge_lora(params, JCFG, sd)
    full = lora.apply_lora_adapters(dit, ad)
    for mod, names in lora.ADAPTER_TARGETS.items():
        for name in names:
            for i in range(JCFG.num_layers):
                np.testing.assert_allclose(
                    full[f"blocks.{i}.{mod}.{name}.weight"].detach().numpy(),
                    np.asarray(merged["blocks"][mod][name]["kernel"][i]).T,
                    **TOL)


def _inputs(cfg):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, cfg.in_dim, 5, 4, 6)).astype(np.float32)
    ctx = rng.standard_normal((1, cfg.text_len, cfg.text_dim)
                              ).astype(np.float32)
    cos, sin = jwan_dit.make_rope_for_geometry(cfg, (5, 2, 3), f_src=2,
                                               f_ground=1)
    t = np.array([500.0], np.float32)
    return x, t, ctx, cos, sin


@pytest.mark.parametrize("remat", [False, True])
def test_forward_with_lora_matches_jax(pair, remat):
    """`WanDiT.forward(lora=...)` (per-block fusion inside each block's
    call) against JAX's in-scan fusion, and against the forward over the
    port's full fused tree."""
    params, dit, jad, ad = pair
    scale = ad.scale
    x, t, ctx, cos, sin = _inputs(JCFG)
    want = np.asarray(jwan_dit.wan_dit_forward(
        params, JCFG, *(jnp.asarray(a) for a in (x, t, ctx, cos, sin)),
        lora=(jad["blocks"], scale), remat_blocks=remat))
    targs = [torch.from_numpy(np.asarray(a)) for a in (x, t, ctx, cos, sin)]
    got = dit(*targs, lora=(ad, scale), remat_blocks=remat)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4)
    full = lora.apply_lora_adapters(dit, ad)
    via_full = torch.func.functional_call(dit, full, tuple(targs))
    torch.testing.assert_close(got, via_full, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        plain = dit(*targs)
    assert (got - plain).abs().max() > 1e-4


def test_init_is_identity():
    cfg = convert.config_from(WanDiTConfig, JCFG)
    g = torch.Generator().manual_seed(0)
    ad = lora.init_lora_adapters(cfg, g, rank=8)
    assert (ad.rank, ad.alpha, ad.scale) == (8, 8.0, 1.0)
    downs = torch.cat([b[m][n].down.detach().flatten() for b in ad.blocks
                       for m, ns in lora.ADAPTER_TARGETS.items() for n in ns])
    ups = [b[m][n].up.detach() for b in ad.blocks
           for m, ns in lora.ADAPTER_TARGETS.items() for n in ns]
    assert all(float(u.abs().max()) == 0.0 for u in ups)
    assert abs(float(downs.std()) * 8 - 1.0) < 0.05
    assert ad.blocks[0]["ffn"]["fc1"].down.shape == (8, cfg.dim)
    assert ad.blocks[0]["ffn"]["fc1"].up.shape == (cfg.ffn_dim, 8)
    dit = wan_dit.init_wan_dit(cfg, g)
    x, t, ctx, cos, sin = (torch.from_numpy(np.asarray(a))
                           for a in _inputs(JCFG))
    with torch.no_grad():
        torch.testing.assert_close(dit(x, t, ctx, cos, sin, lora=(ad, 1.0)),
                                   dit(x, t, ctx, cos, sin), rtol=0, atol=0)
