"""fp8 weight storage of the port (`videocof_torch/utils/fp8.py`) against
the JAX package's (`videocof_tpu/utils/fp8.py`): the quantization bit for
bit against JAX's numpy path (fp8 bits and scales), within one ulp of scale
and one fp8 level against its jit path (XLA turns ``/ 448`` into a product
with the reciprocal), the set of quantized weights, the bytes, the
quantized DiT's forward against JAX's `wan_dit_forward` on the same
quantized tree, the fp8 forward against the unquantized one (JAX's bound),
the per-block LoRA fusion over fp8 (JAX's rounding), and `merge_lora`'s
refusal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videocof_tpu.configs import WAN_TINY as J_WAN
from videocof_tpu.models import lora as jlora, wan_dit as jdit
from videocof_tpu.utils import fp8 as jfp8
from videocof_torch import convert
from videocof_torch.configs import WanDiTConfig
from videocof_torch.models import lora
from videocof_torch.models.wan_dit import WanDiT
from videocof_torch.utils import fp8

torch.set_num_threads(1)

CFG = convert.config_from(WanDiTConfig, J_WAN)
GRID = (3, 4, 4)
FWD_REL = 1e-2      # the same bf16 products of the same bf16 weights (2.1e-3)


def _jax_params(dtype=jnp.float32):
    """JAX's DiT init in ``dtype`` (its time layers and modulations fp32)."""
    return jax.tree.map(np.asarray, jdit.init_wan_dit(
        jax.random.PRNGKey(0), J_WAN, dtype=dtype))


def _port(params, dtype=torch.float32):
    """The port's DiT in ``dtype`` holding ``params``."""
    dit = WanDiT(CFG, dtype=dtype)
    sd = convert.dit_from_jax(jax.tree.map(
        lambda a: np.asarray(a, np.float32), params))
    own = dit.state_dict()
    dit.load_state_dict({k: v.to(own[k].dtype) for k, v in sd.items()})
    return dit


def _leaf(tree, name):
    """(node, layer or None) of the port's linear weight ``name`` in a JAX
    tree."""
    path = convert.jax_param_path(name).split("/")
    for p in path:
        tree = tree[p]
    return tree, (int(name.split(".")[1]) if path[0] == "blocks" else None)


def _levels(a, b):
    """|signed fp8 level index of a - of b| (the bit patterns, sign and
    magnitude)."""
    def idx(x):
        bits = np.asarray(x).view(np.uint8).astype(np.int32)
        return np.where(bits & 0x80, -(bits & 0x7F), bits & 0x7F)
    return np.abs(idx(a) - idx(b))


@pytest.mark.parametrize("dtype,tdtype", [(jnp.float32, torch.float32),
                                          (jnp.bfloat16, torch.bfloat16)])
def test_quantization_equals_jax_numpy_bitwise(dtype, tdtype):
    params = _jax_params(dtype)
    q = jfp8.quantize_params_fp8(params)
    dit = _port(params, tdtype)
    fp8.quantize_dit_fp8(dit)
    quantized = 0
    for name, mod in dit.named_modules():
        if not isinstance(mod, torch.nn.Linear):
            continue
        node, layer = _leaf(q, name + ".weight")
        assert fp8.is_fp8(mod) == jfp8.is_fp8_leaf(node), name
        if not fp8.is_fp8(mod):
            continue
        bits, scale = node["fp8"], np.asarray(node["scale"], np.float32)
        if layer is not None:
            bits, scale = bits[layer], scale[layer]
        np.testing.assert_array_equal(
            mod.weight.view(torch.uint8).numpy(),
            np.swapaxes(bits, -1, -2).view(np.uint8))
        assert mod.weight_scale.dtype == torch.float32
        assert mod.weight_scale.numpy().tobytes() == scale.tobytes(), name
        quantized += 1
    assert quantized == 3 + 10 * CFG.num_layers + 1


def test_stacked_slab_equals_jax_numpy_bitwise():
    slab = np.random.default_rng(0).standard_normal((3, 512, 384)).astype(
        np.float32) * np.array([1e-3, 1.0, 40.0], np.float32)[:, None, None]
    q = jfp8.quantize_params_fp8({"blocks": {"w": {"kernel": slab}}})
    want = q["blocks"]["w"]["kernel"]
    for i in range(3):
        bits, scale = fp8.quantize_weight(torch.from_numpy(slab[i]))
        np.testing.assert_array_equal(bits.view(torch.uint8).numpy(),
                                      want["fp8"][i].view(np.uint8))
        assert scale.numpy().tobytes() == want["scale"][i].tobytes()


def test_within_one_ulp_and_one_level_of_jax_jit():
    """JAX's jit path on a [40, 512, 384] stacked slab: XLA computes
    ``/ 448`` as a product with the fp32 reciprocal, so a scale may sit one
    ulp off and a value one fp8 level off."""
    slab = np.random.default_rng(1).standard_normal((40, 512, 384)).astype(
        np.float32)
    jq = jax.jit(jfp8.quantize_params_fp8)(
        {"blocks": {"w": {"kernel": jnp.asarray(slab)}}})["blocks"]["w"][
            "kernel"]
    jbits, jscale = np.asarray(jq["fp8"]), np.asarray(jq["scale"])
    flips = 0
    for i in range(40):
        bits, scale = fp8.quantize_weight(torch.from_numpy(slab[i]))
        s = scale.numpy()
        assert abs(float(s) - float(jscale[i])) <= np.spacing(s), i
        lv = _levels(bits.view(torch.uint8).numpy(), jbits[i])
        assert lv.max() <= 1, i
        flips += int(lv.sum())
    assert flips <= 1e-5 * slab.size, flips


def test_bytes_equal_jax_and_about_halved():
    params = _jax_params(jnp.bfloat16)
    dit = _port(params, torch.bfloat16)
    bf16_blocks = fp8.fp8_bytes(dit.blocks)
    fp8.quantize_dit_fp8(dit)
    q = jfp8.quantize_params_fp8(params)
    # the time layers and modulations are fp32 in both packages
    assert fp8.fp8_bytes(dit) == jfp8.fp8_bytes(q)
    ratio = fp8.fp8_bytes(dit.blocks) / bf16_blocks
    assert 0.5 < ratio < 0.6, ratio


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    f, h, w = GRID
    x = rng.standard_normal((1, J_WAN.in_dim, f, 2 * h, 2 * w)).astype(
        np.float32)
    ctx = rng.standard_normal((1, J_WAN.text_len, J_WAN.text_dim)).astype(
        np.float32)
    cos, sin = jdit.make_rope_for_geometry(J_WAN, GRID)
    return x, ctx, cos, sin


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_quantized_forward_matches_jax():
    params = _jax_params()
    q = jfp8.quantize_params_fp8(params)
    dit = fp8.quantize_dit_fp8(_port(params))
    x, ctx, cos, sin = _inputs()
    want = np.asarray(jdit.wan_dit_forward(
        jax.tree.map(jnp.asarray, q), J_WAN, jnp.asarray(x),
        jnp.array([500.0]), jnp.asarray(ctx), jnp.asarray(cos),
        jnp.asarray(sin)))
    with torch.no_grad():
        got = dit(torch.tensor(x), torch.tensor([500.0]), torch.tensor(ctx),
                  torch.tensor(cos), torch.tensor(sin)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _rel(got, want) <= FWD_REL


def test_fp8_forward_close_to_unquantized():
    """JAX's bound (`tests/test_fp8.py`): fp8 weights with bf16 compute
    against the fp32 forward, mean |err| < 0.05 mean |base| + 0.05."""
    params = _jax_params()
    dit = _port(params)
    x, ctx, cos, sin = (torch.tensor(a) for a in _inputs(2))
    t = torch.tensor([500.0])
    with torch.no_grad():
        base = dit(x, t, ctx, cos, sin).numpy()
        fp8.quantize_dit_fp8(dit)
        out = dit(x, t, ctx, cos, sin).numpy()
    err = np.abs(out - base)
    assert err.mean() < 0.05 * np.abs(base).mean() + 0.05
    assert np.isfinite(out).all()


def test_dequantize_matches_jax():
    params = _jax_params()
    q = jfp8.quantize_params_fp8(params)
    dit = fp8.quantize_dit_fp8(_port(params))
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16),
                          (torch.float32, jnp.float32)):
        lin = dit.blocks[1].ffn.fc1
        node, layer = _leaf(q, "blocks.1.ffn.fc1.weight")
        want = np.asarray(jfp8.dequantize_leaf(node, jdtype)[layer]
                          ).astype(np.float32)
        got = fp8.dequantize(lin, dtype)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(), want.T)
    assert fp8.compute_dtype(dit.blocks[0].self_attn.q) == torch.bfloat16
    assert fp8.compute_dtype(dit.time_mlp.fc1) == torch.float32
    assert not fp8.is_fp8(dit.time_proj.fc)


def test_fused_adapters_over_fp8_match_jax():
    """W_eff = (q.float() * scale + s up @ down).to(bf16): one rounding from
    fp32, JAX's `fuse_block_adapters` over fp8 storage."""
    params = _jax_params()
    q = jfp8.quantize_params_fp8(params)
    dit = fp8.quantize_dit_fp8(_port(params))
    rng = np.random.default_rng(3)
    d, f, r = CFG.dim, CFG.ffn_dim, 4
    jad, ad = {}, lora.LoRAAdapters(CFG, r, float(r))
    for mod, names in lora.ADAPTER_TARGETS.items():
        for name in names:
            din, dout = lora._target_dims(CFG)[(mod, name)]
            down = rng.standard_normal((r, din)).astype(np.float32) * 0.1
            up = rng.standard_normal((dout, r)).astype(np.float32) * 0.1
            jad.setdefault(mod, {})[name] = {"down": jnp.asarray(down),
                                             "up": jnp.asarray(up)}
            lin = ad.blocks[1][mod][name]
            lin.down.data, lin.up.data = torch.tensor(down), torch.tensor(up)
    jblock = jax.tree.map(lambda a: a[1], q["blocks"])
    want = jlora.fuse_block_adapters(jblock, jad, 0.5)
    got = lora.fuse_block_adapters(dit.blocks[1], ad.blocks[1], 0.5)
    assert len(got) == 10
    for key, w in got.items():
        mod, name, _ = key.split(".")
        ref = np.asarray(want[mod][name]["kernel"]).astype(np.float32).T
        assert w.dtype == torch.bfloat16
        # the adapters' fp32 product sums in another order in XLA: at most
        # one bf16 ulp apart
        w = w.detach().float().numpy()
        np.testing.assert_allclose(w, ref, rtol=2 ** -7,
                                   atol=1e-6)
        assert (w != ref).mean() < 0.02


def test_merge_lora_refuses_a_quantized_dit():
    dit = fp8.quantize_dit_fp8(_port(_jax_params()))
    rank, d = 2, CFG.dim
    rng = np.random.default_rng(8)
    sd = {"diffusion_model.blocks.0.self_attn.q.lora_A.weight":
          torch.tensor(rng.standard_normal((rank, d)), dtype=torch.float32),
          "diffusion_model.blocks.0.self_attn.q.lora_B.weight":
          torch.tensor(rng.standard_normal((d, rank)), dtype=torch.float32)}
    with pytest.raises(ValueError, match="fp8-quantized"):
        lora.merge_lora(dit, sd)
