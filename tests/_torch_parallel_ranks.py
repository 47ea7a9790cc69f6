"""The rank side of the port's parallel tests (`test_torch_parallel.py`,
`test_torch_parallel_train.py`): `run_world` spawns a gloo world of CPU
processes once, each rank runs the named cases on the inputs the parent
made (numpy arrays and the port's state dicts, carried from JAX's weights
by `videocof_torch.convert`), and the parent gets every rank's results.

This module imports neither JAX nor the JAX package: the spawned ranks
import it and run the port alone."""

import os

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run_world(world, tmp_path, cases, payload):
    """[rank -> {case: result}] of ``cases`` (names of the ``case_*``
    functions below, with the mesh each asks for) run in every rank of a
    gloo world of ``world`` processes, rendezvous through a file under
    ``tmp_path``."""
    out = tmp_path / f"world{world}"
    out.mkdir(parents=True, exist_ok=True)
    torch.save(payload, out / "payload.pt")
    mp.start_processes(_rank_main, args=(world, str(out), list(cases)),
                       nprocs=world, join=True, start_method="spawn")
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _rank_main(rank, world, out, cases):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/rdzv",
                            world_size=world, rank=rank)
    payload = torch.load(os.path.join(out, "payload.pt"), weights_only=False)
    results = {}
    for name in cases:
        results[name] = globals()["case_" + name](payload, world)
    dist.barrier()
    dist.destroy_process_group()
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))


# the CFG edit with TeaCache pinned to replay at step 2 and cfg-skip from
# step 2 on
TEACACHE_CFG_SKIP = dict(num_inference_steps=4, guidance_scale=5.0,
                         negative_prompt="blurry", enable_teacache=True,
                         teacache_forced_plan=[False, False, True, False],
                         cfg_skip_ratio=0.5)


# ------------------------------------------------------------------ helpers

def _np(t):
    return t.detach().float().cpu().numpy().copy()


def _mesh(data, seq):
    from videocof_torch.parallel import make_mesh
    return make_mesh(data=data, seq=seq)


def _dit(sd, cfg):
    from videocof_torch.models.wan_dit import WanDiT
    dit = WanDiT(cfg)
    dit.load_state_dict(sd)
    return dit


def _pipeline(p, dit_key="dit"):
    """The tiny fp32 CPU pipeline of the payload's weights (two experts
    when the payload has ``dit_2``)."""
    from videocof_torch.models.t5_encoder import T5Encoder
    from videocof_torch.models.wan_vae import WanVAE
    from videocof_torch.pipeline import Wan22Pipeline, WanPipeline
    vae = WanVAE(p["vae_cfg"])
    vae.load_state_dict(p["vae"])
    t5 = T5Encoder(p["t5_cfg"])
    t5.load_state_dict(p["t5"])
    kw = dict(dtype=torch.float32, device="cpu")
    if dit_key == "wan22":
        return Wan22Pipeline(_dit(p["dit"], p["dit_cfg"]), vae, t5,
                             dit_2=_dit(p["dit_2"], p["dit_cfg"]),
                             boundary=0.9, **kw)
    return WanPipeline(_dit(p["dit"], p["dit_cfg"]), vae, t5, **kw)


def _edit(pipe, p, **kw):
    out = pipe(p["video"], p["prompt"], noise=p["noise"], output_latents=True,
               **{**p["edit_kw"], **kw})
    return {"videos": out.videos, "ground_videos": out.ground_videos,
            "latents": out.latents}


def record_grads(state):
    """A dict that receives the trained tensors' gradients as AdamW takes
    them (reduced over the mesh and clipped; FSDP shards gathered whole)
    at each step of ``state``."""
    from videocof_torch.utils.checkpoint import whole_state
    grads = {}
    adamw_step = state.optimizer.adamw.step
    module = getattr(state, "adapters", None) or state.params

    def recording_step(*args, **kw):
        for name, prm in module.named_parameters():
            grads[name] = _np(whole_state(prm.grad))
        return adamw_step(*args, **kw)

    state.optimizer.adamw.step = recording_step
    return grads


# -------------------------------------------------------------------- cases

def case_mesh(p, world):
    """The mesh's axes, and make_mesh's refusals."""
    from videocof_torch.parallel import make_mesh
    from videocof_torch.parallel.mesh import axis_size
    res = {}
    for data in (1, 2):
        if world % data:
            continue
        mesh = make_mesh(data=data, seq=world // data)
        res[f"data{data}"] = ({a: axis_size(mesh, a) for a in
                               mesh.mesh_dim_names},
                              mesh.get_local_rank("data"),
                              mesh.get_local_rank("seq"))
    try:
        make_mesh(data=world, seq=2)
    except ValueError as e:
        res["too_big"] = str(e)
    return res


def case_collectives(p, world):
    """The autograd collectives over the seq group: values and gradients of
    a loss that every rank computes alike from the collective's output."""
    from videocof_torch.parallel import SPContext
    from videocof_torch.parallel._collectives import (all_reduce_sum,
                                                      all_to_all,
                                                      gather_tokens)
    sp = SPContext(_mesh(1, world))
    x = torch.from_numpy(p["coll"])                    # [2, 8, 4, 3] whole
    w = torch.from_numpy(p["coll_w"])
    res = {}
    for name in ("all_to_all", "gather_tokens", "all_reduce_sum"):
        mine = sp.shard_tokens(x).clone().requires_grad_()
        if name == "all_to_all":
            # tokens <-> heads and back; the loss on this rank's heads
            y = all_to_all(mine, sp.group, scatter_dim=2, gather_dim=1)
            out = y
            loss = (y * w.chunk(world, dim=2)[sp.rank]).sum()
        elif name == "gather_tokens":
            out = gather_tokens(mine, sp.group, dim=1)
            loss = (out * w).sum()
        else:
            out = all_reduce_sum(mine, sp.group)
            loss = (out * w.chunk(world, dim=1)[0]).sum()
        loss.backward()
        res[name] = (_np(out), _np(mine.grad))
    return res


def _attention_case(p, world, key):
    from videocof_torch.parallel import (SPContext, make_ring_attention,
                                         make_ulysses_attention)
    mesh = _mesh(1, world)
    sp = SPContext(mesh)
    q, k, v, mask = (torch.from_numpy(p[key][n]) for n in "qkvm")
    res = {"rank": sp.rank}
    for mode, maker in (("ulysses", make_ulysses_attention),
                        ("ring", make_ring_attention)):
        attn = maker(mesh)
        with torch.no_grad():
            for masked in (False, True):
                o = attn(*(sp.shard_tokens(t) for t in (q, k, v)),
                         mask=mask if masked else None)
                res[(mode, masked)] = _np(o)
    return res


def case_attention24(p, world):
    """Ulysses and ring (its fp32 einsum path) at head dim 24."""
    return _attention_case(p, world, "attn24")


def case_ring128(p, world):
    """Ring's kernel path (B2's plain version per rotated shard) at head
    dim 128 with a key mask."""
    from videocof_torch.parallel import SPContext, make_ring_attention
    mesh = _mesh(1, world)
    sp = SPContext(mesh)
    q, k, v, mask = (torch.from_numpy(p["attn128"][n]) for n in "qkvm")
    with torch.no_grad():
        o = make_ring_attention(mesh)(*(sp.shard_tokens(t) for t in (q, k, v)),
                                      mask=mask)
    return {"rank": sp.rank, "out": _np(o)}


def case_dit(p, world):
    """The whole DiT forward, sequence-parallel in both modes, at a token
    count that does not divide the seq axis; the token count each block
    sees."""
    from videocof_torch.parallel import (SPContext, make_ring_attention,
                                         make_ulysses_attention)
    mesh = _mesh(1, world)
    dit = _dit(p["dit"], p["dit_cfg"])
    seen = []
    dit.blocks[0].register_forward_pre_hook(
        lambda mod, args: seen.append(tuple(args[0].shape)))
    args = [torch.from_numpy(a) for a in p["dit_in"]]
    res = {}
    with torch.no_grad():
        for mode, maker in (("ulysses", make_ulysses_attention),
                            ("ring", make_ring_attention)):
            res[mode] = _np(dit(*args, attn_backend=maker(mesh),
                                sp=SPContext(mesh)))
    res["block_input_shapes"] = seen
    return res


def case_pipeline(p, world):
    """The CoF edit sequence-parallel (Ulysses and ring), and the guard
    that CFG parallelism needs a data axis."""
    pipe = _pipeline(p)
    res = {}
    for mode in ("ulysses", "ring"):
        pipe.enable_sequence_parallel(data=1, seq=world, mode=mode)
        res[mode] = _edit(pipe, p)
        pipe.disable_sequence_parallel()
    try:
        pipe.enable_sequence_parallel(data=1, seq=world, cfg_parallel=True)
    except ValueError as e:
        res["cfg_parallel_without_data"] = str(e)
    return res


def case_cfg_parallel(p, world):
    """The CFG edit with one guidance branch per data rank (data 2, seq
    world / 2), each rank's CFG batch rows."""
    pipe = _pipeline(p)
    pipe.enable_sequence_parallel(data=2, seq=world // 2, mode="ulysses",
                                  cfg_parallel=True)
    rows = []
    dit = pipe.dit
    dit.blocks[0].register_forward_pre_hook(
        lambda mod, args: rows.append(tuple(args[0].shape)))
    out = _edit(pipe, p, guidance_scale=5.0,
                negative_prompt=p["negative_prompt"])
    out["block_input_shapes"] = rows
    # TeaCache's residual across the cut of cfg-skip: step 2 replays step
    # 1's residual (a CFG step's, one branch a rank) on the cond rows
    out["teacache"] = _edit(pipe, p, **TEACACHE_CFG_SKIP)
    return out


def case_wan22(p, world):
    """The Wan2.2 dual-expert edit, both experts sequence-parallel."""
    pipe = _pipeline(p, "wan22")
    pipe.enable_sequence_parallel(data=1, seq=world, mode="ulysses")
    return _edit(pipe, p, num_inference_steps=4, guidance_scale=1.0)


def case_fsdp(p, world):
    """The FSDP rule over a data axis of 2, and the placements
    `apply_fsdp` gives the DiT."""
    from torch.distributed.tensor import DTensor
    from videocof_torch.parallel import apply_fsdp, fsdp_param_sharding
    mesh = _mesh(2, world // 2)
    dit = _dit(p["dit"], p["dit_cfg"])
    rule = fsdp_param_sharding(mesh, dit, min_size=p["fsdp_min_size"])
    apply_fsdp(dit, mesh, min_size=p["fsdp_min_size"])
    placed = {}
    for name, prm in dit.named_parameters():
        if isinstance(prm, DTensor):
            placed[name] = (prm.placements[0].dim,
                            tuple(prm.to_local().shape))
        else:
            placed[name] = (None, tuple(prm.shape))
    return {"rule": rule, "placed": placed}


# ---------------------------------------------------------------- training

def _batch(p, rows):
    b = {k: torch.from_numpy(v) for k, v in p["batch"].items()}
    for k in ("x0", "context", "timesteps"):
        b[k] = b[k][rows]
    return b


def _lora_step(p, data, seq, fsdp_base):
    from videocof_torch import convert
    from videocof_torch.training.train_step import (adamw,
                                                    make_lora_train_step)
    mesh = _mesh(data, seq)
    dit = _dit(p["dit"], p["dit_cfg"])
    if fsdp_base:
        from videocof_torch.parallel import apply_fsdp
        apply_fsdp(dit, mesh, min_size=p["fsdp_min_size"])
    init_fn, step_fn = make_lora_train_step(
        dit, adamw(1e-3, 0.0, p["lora_clip"]), rank=p["rank"], mesh=mesh)
    state = init_fn(adapters=convert.lora_from_jax(p["adapters"],
                                                   p["dit_cfg"]))
    grads = record_grads(state)
    d = mesh.get_local_rank("data")
    rows = p["batch"]["x0"].shape[0] // data
    mine = slice(d * rows, (d + 1) * rows)
    state, loss = step_fn(state, _batch(p, mine),
                          noise=torch.from_numpy(p["noise"][mine]))
    return {"loss": float(loss), "grads": grads,
            "trained": {k: _np(v) for k, v in
                         state.adapters.state_dict().items()}}


def case_lora_data(p, world):
    """One LoRA step over data ``world`` (the frozen base FSDP-sharded)."""
    return _lora_step(p, world, 1, fsdp_base=True)


def case_lora_seq(p, world):
    """One LoRA step over seq ``world`` (Ulysses)."""
    return _lora_step(p, 1, world, fsdp_base=False)


def case_lora_data_seq(p, world):
    """One LoRA step over data 2 x seq ``world / 2``."""
    return _lora_step(p, 2, world // 2, fsdp_base=True)


def case_full_data(p, world):
    """One full fine-tuning step over data 2 x seq ``world / 2``: the
    parameters and AdamW moments FSDP-sharded, gathered after the step."""
    from videocof_torch.training.train_step import adamw, make_train_step
    from videocof_torch.utils.checkpoint import whole_state
    mesh = _mesh(2, world // 2)
    dit = _dit(p["dit"], p["dit_cfg"])
    init_fn, step_fn = make_train_step(
        dit, adamw(1e-3, 1e-3, p["full_clip"]), mesh=mesh,
        fsdp_min_size=p["fsdp_min_size"])
    state = init_fn()
    grads = record_grads(state)
    d = mesh.get_local_rank("data")
    rows = p["batch"]["x0"].shape[0] // 2
    mine = slice(d * rows, (d + 1) * rows)
    state, loss = step_fn(state, _batch(p, mine),
                          noise=torch.from_numpy(p["noise"][mine]))
    sd = whole_state(state.params.state_dict())
    n_sharded = sum(type(v).__name__ == "DTensor"
                    for v in state.params.state_dict().values())
    return {"loss": float(loss), "grads": grads, "n_sharded": n_sharded,
            "trained": {k: _np(v) for k, v in sd.items()}}


def case_trainer(p, world):
    """`CoFTrainer` over data 2 x seq ``world / 2``: its first step's loss
    and the adapters after it, the timesteps it drew, the rows each rank
    prepared, and a saved state."""
    from videocof_torch.utils import checkpoint
    tr = _trainer(p, mesh_data=2, mesh_seq=world // 2)
    drawn = []
    draw = tr.draw_timesteps
    tr.draw_timesteps = lambda: drawn.append(draw()) or drawn[-1]
    rows = []
    tr.prepare_batch = _recording(tr.prepare_batch, rows)
    grads = record_grads(tr.state)
    tr.train(_samples(p), total_steps=1)
    path = checkpoint.save_train_state(p["ckpt_dir"], tr.state)
    dist.barrier()                   # rank 0 has written it
    return {"loss": tr.losses[0], "timesteps": [_np(t) for t in drawn],
            "rows": rows, "saved": os.path.isdir(path), "grads": grads,
            "trained": {k: _np(v) for k, v in
                         tr.state.adapters.state_dict().items()}}


def _recording(prepare, rows):
    def wrapped(samples):
        rows.append([s["text"] for s in samples])
        return prepare(samples)
    return wrapped


def _trainer(p, offload_t5=False, bands=None, **kw):
    """A tiny CPU `CoFTrainer` on the payload's weights (``kw``: its
    `TrainerConfig`'s fields beside the payload's); ``bands``: a sampler of
    that many timestep bands in place of its own (``mesh_data``), so that
    one process repeats a data-parallel run's draws."""
    from videocof_torch.models.t5_encoder import T5Encoder
    from videocof_torch.models.wan_vae import WanVAE
    from videocof_torch.training import (CoFTrainer, DiscreteSampling,
                                         TrainerConfig)
    vae = WanVAE(p["vae_cfg"])
    vae.load_state_dict(p["vae"])
    t5 = T5Encoder(p["t5_cfg"])
    t5.load_state_dict(p["t5"])
    tr = CoFTrainer(_dit(p["dit"], p["dit_cfg"]), vae, t5, None,
                    TrainerConfig(**p["tcfg"], **kw), device="cpu",
                    offload_t5=offload_t5)
    if bands is not None:
        tr.sampler = DiscreteSampling(group_num=bands)
    return tr


def _samples(p):
    return iter(p["samples"])


# ------------------------------------------------- the non-Wan families

def _family_module(entry):
    from videocof_torch.models import cogvideox, flux, qwenimage
    cls = {"cogvideox": cogvideox.CogVideoX, "flux": flux.Flux,
           "qwenimage": qwenimage.QwenImage}[entry["family"]]
    m = cls(entry["cfg"])
    m.load_state_dict(entry["sd"])
    return m


def case_family_forwards(p, world):
    """Each family's whole forward sequence-parallel over the world, in
    both modes, at stream lengths that do not divide the seq axis
    (QwenImage with a ragged text mask too)."""
    from videocof_torch.parallel import (SPContext, make_ring_attention,
                                         make_ulysses_attention)
    mesh = _mesh(1, world)
    res = {}
    for name, entry in p["families"].items():
        m = _family_module(entry)
        args = [torch.from_numpy(a) for a in entry["args"]]
        kw = {k: torch.from_numpy(v) for k, v in entry["kw"].items()}
        for mode, maker in (("ulysses", make_ulysses_attention),
                            ("ring", make_ring_attention)):
            with torch.no_grad():
                res[(name, mode)] = _np(m(*args, attn_backend=maker(mesh),
                                          sp=SPContext(mesh), **kw))
    return res


def case_family_pipeline(p, world):
    """The Flux pipeline with `enable_sequence_parallel` (each mode), from
    the given start latents; and after `disable_sequence_parallel`."""
    from videocof_torch.pipeline import FluxPipeline
    entry = p["flux_pipe"]
    pipe = FluxPipeline(_family_module(entry), device="cpu")
    res = {}
    for mode in ("ulysses", "ring"):
        pipe.enable_sequence_parallel(seq=world, mode=mode)
        res[mode] = pipe(*entry["args"], **entry["kw"])
        pipe.disable_sequence_parallel()
    res["local"] = pipe(*entry["args"], **entry["kw"])
    return res
