"""Training-state checkpoints, and writing weights back to the published Wan
layouts.

Counterpart of `videocof_tpu/utils/checkpoint.py`. `save_train_state` and
`restore_train_state` keep orbax's `CheckpointManager` layout (one
subdirectory per step, the latest restored by default) and write with
``torch.save`` only plain tensors, numbers and dicts, which
``torch.load(weights_only=True)`` reads back. They take the full
fine-tuning `TrainState` and the `LoRATrainState`; saving the latter is a
departure from JAX, whose save reads ``state.params`` and raises on it.
As orbax's, the file holds the model's global shapes whatever the state's
layout (FSDP over ``data``, tensor parallelism over ``model``, both), and
a restore cuts them to the layout of the state it fills.
`export_dit_state_dict` and `save_dit_safetensors` are the inverse of
`models.weights.convert_dit_state_dict`, so that weights made or trained by
the port load in the reference and back; and the inverses of the VAE and
umT5 converters, with which `save_wan_checkpoint_dir` writes a whole
checkpoint directory (Wan2.1, the Wan2.2 A14B MoE or the TI2V-5B). The writer is the port's own (no
``safetensors`` package): tensors keep their dtype (bf16 included; JAX's
writer widens everything to fp32), ordered by element size, then name, so
that each starts aligned, behind a header padded to 8 bytes.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Mapping, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from ..configs import T5Config, Wan22VAEConfig, WanDiTConfig
from ..models.weights import (DIT_BLOCK_NAMES, DIT_IMG_BLOCK_NAMES,
                              DIT_IMG_EMB_NAMES, DIT_INDEX, DIT_TOP_NAMES,
                              SAFETENSORS_DTYPES, AnyKey, t5_key_map,
                              vae_key_map)
from ..parallel.tp import shard_param, tp_dims, unshard_param

StateDict = Dict[str, torch.Tensor]
_DTYPE_NAMES = {v: k for k, v in SAFETENSORS_DTYPES.items()}
_STATE_FILE = "train_state.pt"


# ------------------------------------------------------------ train state

def _trained(state: Any) -> tuple:
    """("adapters" or "params", the module a train state trains)."""
    if hasattr(state, "adapters"):
        return "adapters", state.adapters
    return "params", state.params


def checkpoint_steps(path: str) -> list:
    """The steps saved under ``path``, ascending."""
    if not os.path.isdir(path):
        return []
    return sorted(int(d) for d in os.listdir(path) if d.isdigit()
                  and os.path.isfile(os.path.join(path, d, _STATE_FILE)))


def _gather_dim(local: torch.Tensor, dim: int, n: int, group) -> torch.Tensor:
    """``local``, this rank's ``torch.chunk`` shard on ``dim`` of a tensor
    ``n`` long there, gathered whole over ``group`` through the process
    group's ``all_gather_into_tensor`` (DTensor's ``full_tensor`` goes
    through the functional collectives, which crash under gloo on CUDA
    tensors): each shard is padded to the first's length and the gather
    cut back."""
    world = dist.get_world_size(group)
    step = -(-n // world)
    local = local.movedim(dim, 0)
    if local.shape[0] < step:
        local = torch.cat([local, local.new_zeros(
            (step - local.shape[0], *local.shape[1:]))])
    out = local.new_empty((world * step, *local.shape[1:]))
    dist.all_gather_into_tensor(out, local.contiguous(), group=group)
    return out[:n].movedim(0, dim)


def _whole(t: DTensor) -> torch.Tensor:
    """A DTensor sharded on one dim of a 1-D mesh (FSDP2's) gathered
    whole."""
    (place,) = t.placements
    if not isinstance(place, Shard):
        return t.full_tensor()
    return _gather_dim(t.to_local(), place.dim, t.shape[place.dim],
                       t.device_mesh.get_group())


def _chunk(t: torch.Tensor, dim: int, world: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s ``torch.chunk`` shard of ``t`` on ``dim`` (FSDP2's;
    empty past the last chunk)."""
    n = t.shape[dim]
    step = -(-n // world)
    start = min(rank * step, n)
    return t.narrow(dim, start, min(step, n - start))


def whole_state(tree: Any) -> Any:
    """``tree`` (nested dicts and lists) with every DTensor (an FSDP shard)
    gathered whole: a collective, which every rank of its mesh runs."""
    if isinstance(tree, DTensor):
        return _whole(tree)
    if isinstance(tree, dict):
        return {k: whole_state(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(whole_state(v) for v in tree)
    return tree


def _tp_layout(module: torch.nn.Module) -> tuple:
    """(the `TPContext` of a module `parallel.apply_tp` cut, or None;
    {parameter name: the dim it cut, or None})."""
    ctx = getattr(module, "tp", None)
    return (None, {}) if ctx is None else (ctx, tp_dims(module))


def _whole_tensor(name: str, t: torch.Tensor, ctx, dims) -> torch.Tensor:
    """The parameter ``name`` (or its AdamW moment) ``t`` whole: an FSDP
    shard gathered over ``data``, then a TP shard over ``model``."""
    if isinstance(t, DTensor):
        t = _whole(t)
    dim = dims.get(name)
    if ctx is None or dim is None:
        return t
    out = t.new_empty((ctx.size, *t.shape))
    dist.all_gather_into_tensor(out, t.contiguous()[None], group=ctx.group)
    return unshard_param(name, list(out.unbind(0)), dim)


def whole_state_dict(module: torch.nn.Module) -> StateDict:
    """``module``'s state dict at the model's global shapes: every FSDP
    shard gathered over ``data`` and every tensor-parallel shard over
    ``model``. A collective, which every rank of the module's mesh
    runs."""
    ctx, dims = _tp_layout(module)
    return {k: _whole_tensor(k, v, ctx, dims)
            for k, v in module.state_dict().items()}


def _param_names(module: torch.nn.Module, optimizer) -> list:
    """The names of ``optimizer``'s parameters in its state's index
    order (None for one that is not ``module``'s)."""
    names = {id(p): n for n, p in module.named_parameters()}
    return [names.get(id(p)) for g in optimizer.param_groups
            for p in g["params"]]


def _host_payload(module: torch.nn.Module, optimizer, keep: bool) -> dict:
    """The trained module's state dict and ``optimizer``'s state, every
    tensor whole (`_whole_tensor`, a collective) and on the host. One
    tensor is gathered at a time and leaves the device at once, so the
    device never holds more than one whole tensor; a rank that does not
    ``keep`` drops each (its entries are None)."""
    ctx, dims = _tp_layout(module)

    def host(name, t):
        whole = _whole_tensor(name, t, ctx, dims)
        return whole.cpu() if keep else None
    params = {k: host(k, v) for k, v in module.state_dict().items()}
    sd = optimizer.state_dict()
    names = _param_names(module, optimizer)
    state = {i: {k: (host(names[i], v) if torch.is_tensor(v) and k != "step"
                     else v)
                 for k, v in st.items()}
             for i, st in sd["state"].items()}
    return {"module": params, "optimizer": {
        "state": state, "param_groups": sd["param_groups"]}}


def _local_piece(name: str, whole: torch.Tensor, like: torch.Tensor, ctx,
                 dims) -> torch.Tensor:
    """This rank's piece of the whole tensor ``whole`` laid out as ``like``
    (a parameter, a buffer or a moment of this rank's state): its TP
    slice (`shard_param`), then its FSDP shard when ``like`` is a
    DTensor."""
    dim = dims.get(name)
    t = whole
    if ctx is not None and dim is not None:
        t = shard_param(name, t, dim, ctx.size, ctx.rank)
    local = like
    if isinstance(like, DTensor):
        (place,) = like.placements
        if isinstance(place, Shard):
            mesh = like.device_mesh
            t = _chunk(t, place.dim, mesh.size(), mesh.get_local_rank())
        local = like.to_local()
    if tuple(t.shape) != tuple(local.shape):
        raise ValueError(f"{name}: the saved {tuple(whole.shape)} does not "
                         f"cut to this rank's {tuple(local.shape)}")
    return t


def save_train_state(path: str, state: Any) -> str:
    """Write ``state`` (a `TrainState` or a `LoRATrainState`) to
    ``path/<step>/``: the trained module's state dict (the adapters or the
    parameters), the AdamW state (keyed by parameter index, as
    ``torch.optim`` keys it) and the step, every tensor at the model's
    global shape, whatever the layout. The directory appears whole: it is
    written under a temporary name and renamed. Returns it.

    In a `torch.distributed` world every rank calls it: FSDP shards over
    ``data`` and tensor-parallel shards over ``model`` (parameters and
    AdamW moments) are gathered whole one tensor at a time, rank 0 moves
    each to its host memory and alone writes, the other ranks drop theirs,
    and every rank returns once the directory exists. Rank 0's host
    memory, not a card's, holds the whole state."""
    root = os.path.abspath(path)
    step = int(state.step)
    kind, module = _trained(state)
    final = os.path.join(root, str(step))
    distributed = dist.is_initialized()
    writer = not distributed or dist.get_rank() == 0
    whole = _host_payload(module, state.optimizer.adamw, writer)
    payload = {"step": step, kind: whole["module"],
               "optimizer": whole["optimizer"]}
    if writer:
        tmp = final + ".partial"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, _STATE_FILE))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
    del payload, whole
    if distributed:
        dist.barrier()
    return final


def restore_train_state(path: str, state_like: Any,
                        step: Optional[int] = None) -> Any:
    """Load the state saved at ``step`` (the latest by default) into
    ``state_like`` in place and return it. ``state_like`` is a state of the
    same kind built as the saved one was (the same model config, LoRA rank
    and parameter order, since the optimizer state is keyed by parameter
    index), on the device to restore to, in any layout: each whole tensor
    is cut to this rank's piece as ``state_like`` holds it, its TP slice
    over ``model`` (`parallel.apply_tp`), then its FSDP shard over
    ``data`` (a DTensor on the same mesh and placement), the AdamW moments
    as their parameters. A state saved in one layout (none, FSDP, TP or
    TP x FSDP) restores into any other. Every rank maps the file into
    memory (``mmap``) and reads only the pieces it holds; no collective is
    run."""
    root = os.path.abspath(path)
    if step is None:
        steps = checkpoint_steps(root)
        if not steps:
            raise FileNotFoundError(f"no train state under {root}")
        step = steps[-1]
    kind, module = _trained(state_like)
    # mapped, on the host: the pieces copy to their devices (and AdamW
    # keeps its step counts on the host)
    payload = torch.load(os.path.join(root, str(step), _STATE_FILE),
                         map_location="cpu", weights_only=True, mmap=True)
    if kind not in payload:
        raise ValueError(f"step {step} under {root} holds no {kind}")
    saved = payload[kind]
    ctx, dims = _tp_layout(module)
    tensors = module.state_dict(keep_vars=True)
    if set(saved) != set(tensors):
        raise ValueError(
            f"step {step} under {root} holds other tensors than the state: "
            f"missing {sorted(set(tensors) - set(saved))}, unexpected "
            f"{sorted(set(saved) - set(tensors))}")
    with torch.no_grad():
        for k, t in tensors.items():
            piece = _local_piece(k, saved[k], t, ctx, dims)
            (t.to_local() if isinstance(t, DTensor) else t).copy_(piece)
    adamw = state_like.optimizer.adamw
    params = [p for g in adamw.param_groups for p in g["params"]]
    names = _param_names(module, adamw)
    opt = payload["optimizer"]
    state = {}
    for i, st in opt["state"].items():
        p = params[i]
        state[i] = {}
        for k, v in st.items():
            if torch.is_tensor(v) and k != "step":
                v = _local_piece(names[i], v, p, ctx, dims).to(
                    p.device, copy=True).contiguous()
                if isinstance(p, DTensor):
                    v = DTensor.from_local(v, p.device_mesh, p.placements,
                                           run_check=False, shape=p.shape,
                                           stride=p.stride())
            elif torch.is_tensor(v):
                v = v.clone()          # off the mapped file
            state[i][k] = v
    adamw.load_state_dict({"state": state,
                           "param_groups": opt["param_groups"]})
    state_like.step = int(payload["step"])
    return state_like


def write_safetensors(path: str, tensors: Mapping[str, torch.Tensor]) -> int:
    """Write ``tensors`` (on any device) as one ``.safetensors`` file;
    returns the bytes written."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: Dict[str, object] = {}
    offset = 0
    for name in order:
        t = tensors[name]
        if t.dtype not in _DTYPE_NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors "
                             f"name")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _DTYPE_NAMES[t.dtype],
                        "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for name in order:
            t = tensors[name].detach().contiguous().cpu()
            f.write(t.reshape(-1).view(torch.uint8).numpy())
    return 8 + len(raw) + offset


def export_dit_state_dict(sd: Mapping[str, torch.Tensor], cfg: WanDiTConfig
                          ) -> StateDict:
    """`WanDiT` state dict -> the published Wan key layout (the inverse of
    `convert_dit_state_dict`): the patch embedding back to its conv weight
    [O, I, kt, kh, kw], the modulations to [1, n, d] fp32."""
    pt, ph, pw = cfg.patch_size
    out: StateDict = {
        "patch_embedding.weight": sd["patch_embed.weight"].reshape(
            cfg.dim, cfg.in_dim, pt, ph, pw),
        "patch_embedding.bias": sd["patch_embed.bias"],
        "head.modulation": sd["head.modulation"].float()[None],
    }
    for dst, src in DIT_TOP_NAMES.items():
        out[dst + ".weight"] = sd[src + ".weight"]
        out[dst + ".bias"] = sd[src + ".bias"]
    if cfg.model_type == "i2v":
        for dst, (src, w) in DIT_IMG_EMB_NAMES.items():
            out[dst + ".weight"] = sd[f"{src}.{w}"]
            out[dst + ".bias"] = sd[src + ".bias"]
    for i in range(cfg.num_layers):
        out.update(export_block_state_dict(sd, f"blocks.{i}.", f"blocks.{i}.",
                                           cfg))
    return out


def export_block_state_dict(sd: Mapping[str, torch.Tensor], src: str,
                            dst: str, cfg: WanDiTConfig) -> StateDict:
    """One `WanBlock`'s keys under ``src`` -> the published block keys
    under ``dst`` (the inverse of `weights.convert_block_state_dict`)."""
    out: StateDict = {}
    for a, b in DIT_BLOCK_NAMES.items():
        out[dst + a + ".weight"] = sd[src + b + ".weight"]
        out[dst + a + ".bias"] = sd[src + b + ".bias"]
    for a in ("self_attn", "cross_attn"):
        for n in ("norm_q", "norm_k"):
            out[f"{dst}{a}.{n}.weight"] = sd[f"{src}{a}.{n}.weight"]
    out[dst + "modulation"] = sd[src + "modulation"].float()[None]
    if cfg.cross_attn_norm:
        out[dst + "norm3.weight"] = sd[src + "norm3.scale"]
        out[dst + "norm3.bias"] = sd[src + "norm3.bias"]
    if cfg.model_type == "i2v":
        for n in DIT_IMG_BLOCK_NAMES + ("cross_attn.norm_k_img",):
            out[dst + n + ".weight"] = sd[src + n + ".weight"]
            if n != "cross_attn.norm_k_img":
                out[dst + n + ".bias"] = sd[src + n + ".bias"]
    return out


def save_dit_safetensors(path: str, dit: torch.nn.Module,
                         cfg: WanDiTConfig) -> int:
    """One ``.safetensors`` file of ``dit``'s weights in the published
    layout; returns the bytes written."""
    return write_safetensors(path, export_dit_state_dict(dit.state_dict(),
                                                         cfg))


def dit_checkpoint_config(cfg: WanDiTConfig) -> Dict[str, object]:
    """The ``config.json`` of a published Wan2.1 t2v or i2v DiT for
    ``cfg``."""
    return {"_class_name": "WanModel", "model_type": cfg.model_type,
            "patch_size": list(cfg.patch_size), "text_len": cfg.text_len,
            "in_dim": cfg.in_dim, "dim": cfg.dim, "ffn_dim": cfg.ffn_dim,
            "freq_dim": cfg.freq_dim, "text_dim": cfg.text_dim,
            "out_dim": cfg.out_dim, "num_heads": cfg.num_heads,
            "num_layers": cfg.num_layers, "qk_norm": True,
            "cross_attn_norm": cfg.cross_attn_norm, "eps": cfg.eps}


def save_dit_checkpoint_dir(model_dir: str, dit: torch.nn.Module,
                            cfg: WanDiTConfig, num_shards: int = 2,
                            extra: Optional[Mapping[str, torch.Tensor]] = None
                            ) -> int:
    """A checkpoint directory in the published layout: ``config.json``,
    ``num_shards`` safetensors shards of about equal size and their
    ``diffusion_pytorch_model.safetensors.index.json``; returns the bytes of
    the shards. ``extra`` holds published keys written beside the DiT's
    (a VACE branch, a camera adapter)."""
    os.makedirs(model_dir, exist_ok=True)
    sd = export_dit_state_dict(dit.state_dict(), cfg)
    sd.update(extra or {})
    total = sum(t.numel() * t.element_size() for t in sd.values())
    shards = [dict() for _ in range(num_shards)]
    filled = 0
    for name, t in sd.items():
        shards[min(num_shards - 1, filled * num_shards // max(total, 1))][
            name] = t
        filled += t.numel() * t.element_size()
    weight_map, written = {}, 0
    for i, shard in enumerate(shards):
        fname = (f"diffusion_pytorch_model-{i + 1:05d}-of-"
                 f"{num_shards:05d}.safetensors")
        written += write_safetensors(os.path.join(model_dir, fname), shard)
        weight_map.update(dict.fromkeys(shard, fname))
    with open(os.path.join(model_dir, DIT_INDEX), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=1)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(dit_checkpoint_config(cfg), f, indent=1)
    return written


def export_vae_state_dict(sd: Mapping[str, torch.Tensor], cfg) -> StateDict:
    """A `WanVAE` or `Wan22VAE` state dict -> the published
    ``Wan2.1_VAE.pth`` or ``Wan2.2_VAE.pth`` keys (by ``cfg``'s type)."""
    from ..models.wan_vae22 import wan22_vae_key_map
    names = (wan22_vae_key_map(cfg, AnyKey()) if isinstance(
        cfg, Wan22VAEConfig) else vae_key_map(cfg, AnyKey()))
    return {src: sd[dst] for src, dst in names.items() if dst in sd}


def export_t5_state_dict(sd: Mapping[str, torch.Tensor], cfg: T5Config
                         ) -> StateDict:
    """A `T5Encoder` state dict -> the published umT5 keys."""
    return {src: sd[dst] for src, dst in t5_key_map(cfg).items()}


def save_wan_checkpoint_dir(model_dir: str, dit: torch.nn.Module,
                            vae: torch.nn.Module, t5: torch.nn.Module,
                            dit_2: Optional[torch.nn.Module] = None,
                            num_shards: int = 2) -> int:
    """A whole checkpoint directory in the published layout, as
    `factory.load_pipeline` reads it: the DiT's directory at the root, or
    with a high-noise expert ``dit_2`` the Wan2.2 A14B layout
    (``low_noise_model/`` holding ``dit``, ``high_noise_model/`` holding
    ``dit_2``); the VAE as ``Wan2.2_VAE.pth`` for a Wan2.2 VAE (the TI2V-5B
    layout) or ``Wan2.1_VAE.pth``; umT5 as
    ``models_t5_umt5-xxl-enc-bf16.pth``. The DiTs go through the port's
    safetensors writer, the VAE and umT5 through ``torch.save`` (the
    published files are ``.pth``). Returns the bytes written."""
    from .. import factory
    os.makedirs(model_dir, exist_ok=True)
    written = 0
    if dit_2 is None:
        written += save_dit_checkpoint_dir(model_dir, dit, dit.cfg,
                                           num_shards)
    else:
        for sub, d in ((factory.LOW_NOISE_SUBPATH, dit),
                       (factory.HIGH_NOISE_SUBPATH, dit_2)):
            written += save_dit_checkpoint_dir(
                os.path.join(model_dir, sub), d, d.cfg, num_shards)
    vae_name = (factory.VAE22_SUBPATH if isinstance(vae.cfg, Wan22VAEConfig)
                else factory.VAE_SUBPATH)
    for path, sd in ((vae_name, export_vae_state_dict(vae.state_dict(),
                                                      vae.cfg)),
                     (factory.T5_SUBPATH, export_t5_state_dict(
                         t5.state_dict(), t5.cfg))):
        sd = {k: v.detach().cpu() for k, v in sd.items()}
        torch.save(sd, os.path.join(model_dir, path))
        written += sum(v.numel() * v.element_size() for v in sd.values())
    return written


# ------------------------------------------- the non-Wan families' layouts

class _Src:
    """A stand-in tensor that remembers the published key it was read
    under (the converters' ``.to``, ``.float`` and ``.reshape`` keep it)."""

    shape = (1,)

    def __init__(self, key: str):
        self.key = key

    def to(self, *args, **kwargs):
        return self

    def float(self):
        return self

    def reshape(self, *args):
        return self


class _Probe(dict):
    """A state dict holding every key: a converter run over it maps each of
    the port's names to the published one it reads."""

    def __getitem__(self, key):
        return _Src(key)

    def __contains__(self, key) -> bool:
        return True


def export_family_state_dict(module: torch.nn.Module, converter, cfg
                             ) -> StateDict:
    """``module``'s weights under the published (diffusers) names that
    ``converter`` (a family's ``convert_*_state_dict``) reads, in their
    stored dtype: the converter's inverse, taken from the converter
    itself."""
    names = {dst: src.key for dst, src in converter(_Probe(), cfg).items()}
    sd = module.state_dict()
    missing = sorted(set(sd) - set(names))
    if missing:
        raise ValueError(f"no published name for {missing[:4]}")
    return {names[k]: v for k, v in sd.items()}


def _family_tables():
    from ..models import cogvideox, cogvideox_vae, flux, kl_vae, qwenimage
    from ..models.qwenimage_vae import convert_qwenimage_vae_state_dict
    from ..models.wan_vae import WanVAE
    return {
        cogvideox.CogVideoX: ("CogVideoXTransformer3DModel",
                              cogvideox.convert_cogvideox_state_dict),
        flux.Flux: ("FluxTransformer2DModel", flux.convert_flux_state_dict),
        qwenimage.QwenImage: ("QwenImageTransformer2DModel",
                              qwenimage.convert_qwenimage_state_dict),
        cogvideox_vae.CogVideoXVAE: (
            "AutoencoderKLCogVideoX",
            cogvideox_vae.convert_cogvideox_vae_state_dict),
        kl_vae.KLVAEDecoder: ("AutoencoderKL",
                              kl_vae.convert_kl_vae_state_dict),
        WanVAE: ("AutoencoderKLQwenImage", convert_qwenimage_vae_state_dict),
    }


def _save_family_module(path: str, module: torch.nn.Module) -> None:
    import dataclasses
    cls_name, converter = _family_tables()[type(module)]
    os.makedirs(path, exist_ok=True)
    write_safetensors(os.path.join(path, "diffusion_pytorch_model"
                                   ".safetensors"),
                      export_family_state_dict(module, converter, module.cfg))
    config = {"_class_name": cls_name, **dataclasses.asdict(module.cfg)}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=1)


def save_family_checkpoint_dir(model_dir: str, dit: torch.nn.Module,
                               vae: Optional[torch.nn.Module] = None) -> str:
    """Write a CogVideoX, Flux or QwenImage pipeline directory in the
    diffusers layout that `factory.load_family_pipeline` (and JAX's) reads:
    ``transformer/`` and, with ``vae`` (a `CogVideoXVAE`, a
    `KLVAEDecoder` or QwenImage's `WanVAE`), ``vae/``, each a
    ``config.json`` with its ``_class_name`` and one safetensors file.
    Returns ``model_dir``."""
    _save_family_module(os.path.join(model_dir, "transformer"), dit)
    if vae is not None:
        _save_family_module(os.path.join(model_dir, "vae"), vae)
    return model_dir
