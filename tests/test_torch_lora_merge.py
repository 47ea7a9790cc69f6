"""The port's LoRA files against the JAX package's: `parse_lora_state_dict`
on the three key formats (kohya with and without ``.alpha``, Comfy
``diffusion_model.``, bare PEFT ``lora_A``/``lora_B`` with and without
``.default``), and `merge_lora` fusing them into the same tiny DiT, a conv
LoRA on the patch embedding included: to 1e-6 in fp32, to one bf16 ulp in
bf16. Weights and LoRA tensors are drawn from a numpy seed."""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from videocof_tpu.configs import WAN_TINY as J_WAN
from videocof_tpu.models import lora as jlora
from videocof_tpu.models import wan_dit as jdit
from videocof_torch import convert
from videocof_torch.configs import WanDiTConfig
from videocof_torch.models import lora
from videocof_torch.models.wan_dit import WanDiT
from videocof_torch.utils.checkpoint import write_safetensors

torch.set_num_threads(1)

CFG = convert.config_from(WanDiTConfig, J_WAN)
RANK = 4
# published module -> (din, dout); a conv LoRA on the patch embedding
_D, _F = CFG.dim, CFG.ffn_dim
MODULES = {
    "blocks.0.self_attn.q": (_D, _D), "blocks.1.self_attn.o": (_D, _D),
    "blocks.0.cross_attn.k": (_D, _D), "blocks.1.cross_attn.v": (_D, _D),
    "blocks.0.ffn.0": (_D, _F), "blocks.1.ffn.2": (_F, _D),
    "text_embedding.0": (CFG.text_dim, _D), "time_embedding.2": (_D, _D),
    "time_projection.1": (_D, 6 * _D), "head.head": (_D, 64),
    "patch_embedding": None,
}


def _jax_params(seed=0, dtype=np.float32):
    """JAX DiT params of WAN_TINY's tree from a numpy seed: ``dtype`` but
    for the time layers and modulations, which stay fp32 as in the port."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jdit.init_wan_dit(jax.random.PRNGKey(0),
                                                      J_WAN))

    def leaf(path, a):
        keys = [getattr(p, "key", "") for p in path]
        fp32 = keys[0] in ("time_mlp", "time_proj") or "modulation" in keys
        x = rng.standard_normal(a.shape).astype(np.float32)
        return x if fp32 else x.astype(dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _lora_tensors(seed=1):
    """{published module: (down, up)} fp32, the conv one 5-D."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, dims in MODULES.items():
        if dims is None:        # Conv3d [O, I, 1, 2, 2]: down [r, I, 1, 2, 2]
            down = rng.standard_normal((RANK, CFG.in_dim, 1, 2, 2))
            up = rng.standard_normal((CFG.dim, RANK, 1, 1, 1))
        else:
            down = rng.standard_normal((RANK, dims[0]))
            up = rng.standard_normal((dims[1], RANK))
        out[name] = (0.1 * down.astype(np.float32),
                     0.1 * up.astype(np.float32))
    return out


def _state_dict(fmt, tensors, alpha=None):
    sd = {}
    for name, (down, up) in tensors.items():
        if fmt == "kohya":
            base = "lora_unet_" + name.replace(".", "_")
            sd[base + ".lora_down.weight"] = down
            sd[base + ".lora_up.weight"] = up
            if alpha is not None:
                sd[base + ".alpha"] = np.array(alpha, np.float32)
        elif fmt == "comfy":
            base = "diffusion_model." + name
            sd[base + ".lora_down.weight"] = down
            sd[base + ".lora_up.weight"] = up
            if alpha is not None:
                sd[base + ".alpha"] = np.array(alpha, np.float32)
        else:                   # bare PEFT, ".default" on every other module
            infix = ".default" if len(sd) % 4 else ""
            sd[f"{name}.lora_A{infix}.weight"] = down
            sd[f"{name}.lora_B{infix}.weight"] = up
    return sd


def _port_dit(params, dtype):
    dit = WanDiT(CFG, dtype=dtype)
    dit.load_state_dict(convert.dit_from_jax(jax.tree.map(
        lambda a: np.asarray(a, np.float32), params)))
    return dit


def _jax_merged(params, sd, mult):
    out = jlora.merge_lora(params, J_WAN, sd, multiplier=mult)
    return convert.dit_from_jax(jax.tree.map(
        lambda a: np.asarray(a, np.float32), out))


FORMATS = [("kohya", 2.0), ("kohya", None), ("comfy", 8.0), ("comfy", None),
           ("peft", None)]


@pytest.mark.parametrize("fmt,alpha", FORMATS)
def test_parse_matches_jax(fmt, alpha):
    sd = _state_dict(fmt, _lora_tensors(), alpha)
    sd["blocks.9.self_attn.q.lora_A.weight"] = np.zeros((RANK, _D))  # no layer
    sd["lora_unet_blocks_0_norm3.alpha"] = np.array(1.0)             # no module
    want = jlora.parse_lora_state_dict(sd, CFG.num_layers)
    got = lora.parse_lora_state_dict(sd, CFG.num_layers)
    assert set(got) == set(want) == set(MODULES)
    for name, entry in want.items():
        assert set(got[name]) == set(entry)
        assert got[name].get("alpha") == entry.get("alpha")
        for part in ("down", "up"):
            np.testing.assert_array_equal(got[name][part].numpy(),
                                          entry[part])


@pytest.mark.parametrize("mult", [1.0, 0.7])
@pytest.mark.parametrize("fmt,alpha", FORMATS)
def test_merge_matches_jax_fp32(fmt, alpha, mult):
    params = _jax_params()
    sd = _state_dict(fmt, _lora_tensors(), alpha)
    want = _jax_merged(params, sd, mult)
    dit = _port_dit(params, torch.float32)
    before = {k: v.clone() for k, v in dit.state_dict().items()}
    merged = lora.merge_lora(dit, {k: torch.from_numpy(np.asarray(v))
                                   for k, v in sd.items()}, multiplier=mult)
    got = dit.state_dict()
    names = {lora._known_module_names(CFG.num_layers)[m] for m in MODULES}
    assert set(merged) == names
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-6)
        assert torch.equal(got[k], before[k]) == (
            k.rsplit(".", 1)[0] not in names or not k.endswith(".weight")), k


def _assert_within_one_bf16_ulp(got, want):
    got, want = got.float(), want.float()
    ulp = torch.finfo(torch.bfloat16).eps * torch.exp2(torch.floor(
        torch.log2(want.abs().clamp(min=torch.finfo(torch.bfloat16).tiny))))
    assert bool(((got - want).abs() <= ulp).all())


@pytest.mark.parametrize("fmt,alpha", [("kohya", 16.0), ("peft", None)])
def test_merge_matches_jax_bf16_from_files(tmp_path, fmt, alpha):
    """bf16 weights (JAX's checkpoint path holds them as ml_dtypes bf16 on
    the host) and bf16 LoRA files written by the port's writer, read by
    each package's own loader."""
    params = _jax_params(2, ml_dtypes.bfloat16)
    sd = _state_dict(fmt, _lora_tensors(3), alpha)
    path = str(tmp_path / "lora.safetensors")
    write_safetensors(path, {k: torch.from_numpy(np.asarray(v)).to(
        torch.bfloat16) for k, v in sd.items()})
    want = _jax_merged(params, path, 1.0)
    dit = _port_dit(params, torch.bfloat16)
    lora.merge_lora(dit, path)
    got = dit.state_dict()
    for k in want:
        _assert_within_one_bf16_ulp(got[k], want[k].to(got[k].dtype))


def test_merges_apply_in_order_and_reject_wrong_shapes():
    params = _jax_params(4)
    a = _state_dict("kohya", _lora_tensors(5), 2.0)
    b = _state_dict("peft", _lora_tensors(6))
    want = jlora.merge_lora(jlora.merge_lora(params, J_WAN, a), J_WAN, b, 0.5)
    want = convert.dit_from_jax(jax.tree.map(np.asarray, want))
    dit = _port_dit(params, torch.float32)
    lora.merge_lora(dit, a)
    lora.merge_lora(dit, b, multiplier=0.5)
    for k, v in dit.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=1e-6, atol=1e-6)
    bad = {"blocks.0.self_attn.q.lora_A.weight": np.zeros((RANK, _D + 1),
                                                          np.float32),
           "blocks.0.self_attn.q.lora_B.weight": np.zeros((_D, RANK),
                                                          np.float32)}
    with pytest.raises(ValueError, match="self_attn.q"):
        lora.merge_lora(dit, bad)
