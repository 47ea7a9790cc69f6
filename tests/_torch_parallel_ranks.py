"""The rank side of the port's parallel tests (`test_torch_parallel.py`,
`test_torch_parallel_train.py`, `test_torch_image_sp.py`,
`test_torch_tensor_parallel.py`, `test_torch_image_tp.py`,
`test_torch_pipeline_parallel.py`): `run_world` spawns a gloo world of CPU
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


# ------------------------------------------------- tensor parallelism

def _mesh3(data, seq, model):
    from videocof_torch.parallel import make_mesh
    return make_mesh(data=data, seq=seq, model=model)


# the (data, seq, model) layouts of each world's TP cases, and the
# attention each takes: "local", "ulysses" or "ring" over seq
TP_LAYOUTS = {2: {"tp2": ((1, 1, 2), "local")},
              4: {"tp4": ((1, 1, 4), "local"),
                  "tp2_ulysses2": ((1, 2, 2), "ulysses"),
                  "tp2_ring2": ((1, 2, 2), "ring"),
                  "data2_tp2_cfg": ((2, 1, 2), "local")}}


def case_mesh3d(p, world):
    """This rank's (data, seq, model) coordinates in every mesh of the
    world's size."""
    res = {}
    for shape in p["mesh_shapes"][world]:
        mesh = _mesh3(*shape)
        res[shape] = tuple(mesh.get_local_rank(a)
                           for a in ("data", "seq", "model"))
    return res


def _tp_dit(p, key, mesh, quantize=False):
    from videocof_torch.parallel import apply_tp, validate_tp
    dit = _dit(p[key], p[key + "_cfg"])
    if quantize:
        from videocof_torch.utils.fp8 import quantize_dit_fp8
        quantize_dit_fp8(dit)
    validate_tp(dit.cfg, mesh)
    return apply_tp(dit, mesh)


def _tp_forward(dit, mesh, mode, args, kw=None, cfg_parallel=False):
    from videocof_torch.parallel import (SPContext, make_ring_attention,
                                         make_tp_attention)
    sp = None
    if mode == "ring":
        attn = make_ring_attention(mesh, model_axis="model")
    else:
        attn = make_tp_attention(
            mesh, seq_axis="seq" if mode == "ulysses" else None)
    if mode != "local" or cfg_parallel:
        sp = SPContext(mesh, cfg_parallel=cfg_parallel)
    with torch.no_grad():
        return _np(dit(*[torch.from_numpy(a) for a in args],
                       attn_backend=attn, sp=sp,
                       **{k: torch.from_numpy(v)
                          for k, v in (kw or {}).items()}))


def case_tp_forward(p, world):
    """The Wan DiT forward over each TP layout of the world (the CFG layout
    on a batch of 2, one row a data rank), the shard shapes, an i2v DiT,
    fp8 storage and runtime LoRA adapters at tp = world."""
    from videocof_torch.models.lora import LoRAAdapters
    res = {}
    for name, ((d, s, m), mode) in TP_LAYOUTS[world].items():
        mesh = _mesh3(d, s, m)
        dit = _tp_dit(p, "tp_dit", mesh)
        cfgp = name.endswith("cfg")
        res[name] = _tp_forward(dit, mesh, mode,
                                p["tp_in2" if cfgp else "tp_in"],
                                cfg_parallel=cfgp)
    mesh = _mesh3(1, 1, world)
    dit = _tp_dit(p, "tp_dit", mesh)
    res["shapes"] = {k: tuple(v.shape) for k, v in dit.named_parameters()}
    res["i2v"] = _tp_forward(_tp_dit(p, "i2v_dit", mesh), mesh, "local",
                             p["i2v_in"], p["i2v_kw"])
    q = _tp_dit(p, "tp_dit", mesh, quantize=True)
    lin = q.blocks[0].self_attn.q
    res["fp8_q"] = (str(lin.weight.dtype), tuple(lin.weight.shape),
                    float(lin.weight_scale))
    res["fp8"] = _tp_forward(q, mesh, "local", p["tp_in"])
    ad = LoRAAdapters(p["tp_dit_cfg"], 1, 1.0, ranks=p["lora_ranks"])
    ad.load_state_dict(p["lora"])
    dit = _tp_dit(p, "tp_dit", mesh)
    dit.runtime_lora = (ad, p["lora_scale"])
    res["lora"] = _tp_forward(dit, mesh, "local", p["tp_in"])
    return res


def _tp_pipeline(p, moe, mesh_shape, cfg_parallel=False):
    pipe = _pipeline(p, "wan22" if moe else "dit")
    d, s, m = mesh_shape
    pipe.enable_sequence_parallel(data=d, seq=s, model=m,
                                  cfg_parallel=cfg_parallel)
    return pipe


def case_tp_edits(p, world):
    """The CoF edit and the Wan2.2 edit under `enable_sequence_parallel`
    with a model axis (seq 2 x model 2 at world 4, model 2 at world 2),
    the CFG edit with CFG parallelism (data 2 x model 2, world 4), the
    experts' q shard shapes, and the backend `disable_sequence_parallel`
    gives back."""
    shape = (1, 2, 2) if world == 4 else (1, 1, 2)
    pipe = _tp_pipeline(p, False, shape)
    res = {"cof": _edit(pipe, p)}
    pipe.disable_sequence_parallel()
    res["disabled_backend"] = pipe.attn_backend
    pipe = _tp_pipeline(p, True, shape)
    res["wan22"] = _edit(pipe, p, num_inference_steps=4, guidance_scale=1.0)
    res["expert_q"] = [tuple(dit.blocks[0].self_attn.q.weight.shape)
                       for dit in pipe._dits()]
    if world == 4:
        pipe = _tp_pipeline(p, False, (2, 1, 2), cfg_parallel=True)
        res["cfg"] = _edit(pipe, p, guidance_scale=5.0,
                           negative_prompt=p["negative_prompt"])
        pipe = _tp_pipeline(p, True, (2, 1, 2), cfg_parallel=True)
        res["wan22_cfg"] = _edit(pipe, p, num_inference_steps=4,
                                 guidance_scale=5.0,
                                 negative_prompt=p["negative_prompt"])
    return res


def case_tp_train(p, world):
    """One full fine-tuning step over data world/2 x model 2: the loss,
    this rank's parameters after it (its TP shard, FSDP-gathered), the
    gradients AdamW took, the q weight's local shape and placements."""
    from torch.distributed.tensor import DTensor
    from videocof_torch.parallel import tp_param_shardings
    from videocof_torch.training.train_step import adamw, make_train_step
    from videocof_torch.utils.checkpoint import whole_state
    data = world // 2
    mesh = _mesh3(data, 1, 2)
    dit = _dit(p["dit"], p["dit_cfg"])
    dims = tp_param_shardings(mesh, dit)
    init_fn, step_fn = make_train_step(
        dit, adamw(p["lr"], 1e-3, p["full_clip"]), mesh=mesh,
        fsdp_min_size=p["fsdp_min_size"])
    state = init_fn()
    qw = state.params.blocks[0].self_attn.q.weight
    q_local = (tuple(qw.to_local().shape) if isinstance(qw, DTensor)
               else tuple(qw.shape))
    grads = record_grads(state)
    d = mesh.get_local_rank("data")
    rows = p["batch"]["x0"].shape[0] // data
    mine = slice(d * rows, (d + 1) * rows)
    state, loss = step_fn(state, _batch(p, mine),
                          noise=torch.from_numpy(p["train_noise"][mine]))
    sd = whole_state(state.params.state_dict())
    return {"loss": float(loss), "grads": grads, "dims": dims,
            "q_local": q_local, "model_rank": mesh.get_local_rank("model"),
            "trained": {k: _np(v) for k, v in sd.items()}}


# the (data, seq, model) layouts of each world's train-state cases: FSDP
# over data, TP over model, TP x FSDP
RESUME_LAYOUTS = {2: ((2, 1, 1), (1, 1, 2)), 4: ((2, 1, 2),)}


def full_state(p, mesh=None):
    """A fresh full fine-tuning state of the payload's DiT over ``mesh``
    (None: one process) and its step function."""
    from videocof_torch.training.train_step import adamw, make_train_step
    dit = _dit(p["dit"], p["dit_cfg"])
    init_fn, step_fn = make_train_step(
        dit, adamw(p["lr"], 1e-3, p["full_clip"]), mesh=mesh,
        fsdp_min_size=p["fsdp_min_size"])
    return init_fn(), step_fn


def _held(state):
    """Every tensor of a train state as this rank holds it (its shards):
    the parameters and buffers, AdamW's moments and step counts."""
    from torch.distributed.tensor import DTensor

    def local(t):
        return (t.to_local() if isinstance(t, DTensor) else t).detach().clone()
    out = {"module." + k: local(v)
           for k, v in state.params.state_dict().items()}
    for i, st in state.optimizer.adamw.state_dict()["state"].items():
        out.update({f"adamw.{i}.{k}": local(v) for k, v in st.items()})
    return out


def _unequal(got, want):
    """The names whose tensors differ in dtype, shape or any bit (or that
    one side lacks)."""
    return sorted(k for k in set(got) | set(want)
                  if k not in got or k not in want
                  or got[k].dtype != want[k].dtype
                  or not torch.equal(got[k], want[k]))


def case_train_resume(p, world):
    """In each layout of RESUME_LAYOUTS[world]: one full fine-tuning step,
    `save_train_state` (whether the directory exists as it returns on
    this rank), a second step from the state in memory; a fresh state of
    the same layout restored from the file (the names of the tensors this
    rank holds that differ from its own after step 1), and its second
    step (the loss, and the tensors that differ from the second step in
    memory); the whole parameters after the second step in memory."""
    from videocof_torch.utils import checkpoint
    res = {}
    for shape in RESUME_LAYOUTS[world]:
        mesh = _mesh3(*shape)
        d = mesh.get_local_rank("data")
        rows = p["batch"]["x0"].shape[0] // shape[0]
        mine = slice(d * rows, (d + 1) * rows)
        batch = _batch(p, mine)
        n1, n2 = (torch.from_numpy(p[k][mine])
                  for k in ("train_noise", "train_noise2"))
        root = os.path.join(p["ckpt_root"], "x".join(map(str, shape)))
        state, step_fn = full_state(p, mesh)
        state, _ = step_fn(state, batch, noise=n1)
        path = checkpoint.save_train_state(root, state)
        there = os.path.isdir(path)
        saved = _held(state)
        state, loss2 = step_fn(state, batch, noise=n2)
        fresh, fresh_step = full_state(p, mesh)
        checkpoint.restore_train_state(root, fresh)
        restored = _held(fresh)
        fresh, loss2_restored = fresh_step(fresh, batch, noise=n2)
        res[shape] = {
            "path": path, "there": there, "n_held": len(saved),
            "restored_differ": _unequal(restored, saved),
            "loss2": float(loss2), "loss2_restored": float(loss2_restored),
            "step2_differ": _unequal(_held(fresh), _held(state)),
            "whole2": {k: _np(v) for k, v in
                       checkpoint.whole_state_dict(state.params).items()}}
    return res


# ------------------------------------- the image families under TP

def case_image_tp(p, world):
    """Each family's forward tensor-parallel over the world (tp = world),
    and Flux's and QwenImage's over tp 2 x Ulysses seq 2 (world 4); the
    shard of Flux's first single-block proj_out."""
    from videocof_torch.parallel import apply_tp, validate_tp
    layouts = {"tp": ((1, 1, world), "local")}
    if world == 4:
        layouts["tp2_seq2"] = ((1, 2, 2), "ulysses")
    res = {}
    for lname, ((d, s, m), mode) in layouts.items():
        mesh = _mesh3(d, s, m)
        for name, entry in p["families"].items():
            if mode != "local" and entry["family"] == "cogvideox":
                continue
            mod = _family_module(entry)
            validate_tp(mod.cfg, mesh)
            apply_tp(mod, mesh)
            res[(name, lname)] = _tp_forward(mod, mesh, mode, entry["args"],
                                             entry["kw"])
            if entry["family"] == "flux" and lname == "tp":
                blk = mod.single_blocks[0]
                res["flux_proj_out"] = _np(blk.proj_out.weight)
                res["flux_shapes"] = {k: tuple(v.shape) for k, v in
                                      mod.named_parameters()}
    return res


# --------------------------------- pipeline and expert parallelism

def _blocks(p):
    from videocof_torch.models.wan_dit import WanBlock
    blocks = []
    for sd in p["pp_blocks"]:
        blk = WanBlock(p["pp_cfg"], torch.float32, None)
        blk.load_state_dict(sd)
        blocks.append(blk)
    return blocks


def case_pp(p, world):
    """`pp_scan_blocks` over S = world stages at each microbatch count,
    and the gradients of a loss through it (M = 2): this stage's blocks',
    and the input's and the conditioning's."""
    from videocof_torch.parallel import pp_param_shardings, pp_scan_blocks
    mesh = _mesh3(1, world, 1)
    blocks = _blocks(p)
    stage = pp_param_shardings(mesh, blocks)
    ids = [blocks.index(b) for b in stage]
    x, e0, ctx = (torch.from_numpy(p["pp_in"][k]) for k in ("x", "e0",
                                                           "ctx"))
    rope = tuple(torch.from_numpy(a) for a in p["pp_rope"])

    def block_fn(blk, h, cond):
        return blk(h, cond[0], cond[1], rope)

    res = {"stage_ids": ids}
    with torch.no_grad():
        for M in (1, 2, 4):
            res[M] = _np(pp_scan_blocks(mesh, block_fn, stage, x, (e0, ctx),
                                        microbatches=M))
    x_ = x.clone().requires_grad_()
    e0_ = e0.clone().requires_grad_()
    out = pp_scan_blocks(mesh, block_fn, stage, x_, (e0_, ctx),
                         microbatches=2)
    (out ** 2).sum().backward()
    res["grad_x"] = _np(x_.grad)
    res["grad_e0"] = _np(e0_.grad)
    res["grads"] = {f"{i}.{k}": _np(v.grad) for i, blk in zip(ids, stage)
                    for k, v in blk.named_parameters()}
    return res


def _bytes(t):
    return t.reshape(-1).view(torch.uint8)


def case_ep(p, world):
    """Two experts (tiny DiTs) one a rank of the data axis (2 ranks):
    `select_expert(k)` on every rank, its tensors and its forward through
    a shell `WanDiT` on the meta device, in fp32 and in fp8, and each
    owner's forward through its own expert."""
    from torch.func import functional_call
    from videocof_torch.models.wan_dit import WanDiT
    from videocof_torch.parallel import (ep_param_shardings, select_expert,
                                         stack_experts)
    from videocof_torch.utils.fp8 import quantize_dit_fp8
    mesh = _mesh3(2, world // 2, 1)
    owner = mesh.get_local_rank("data")
    args = [torch.from_numpy(a) for a in p["tp_in"]]
    res = {"owner": owner}
    for kind in ("fp32", "fp8"):
        experts = [_dit(p[k], p["tp_dit_cfg"]) for k in ("tp_dit", "dit_b")]
        shell = WanDiT(p["tp_dit_cfg"], device="meta")
        if kind == "fp8":
            for e in experts + [shell]:
                quantize_dit_fp8(e)
        stack = ep_param_shardings(mesh, stack_experts(*experts))
        with torch.no_grad():
            res[(kind, "own")] = _np(experts[owner](*args))
        for k in (0, 1):
            sel = select_expert(stack, k)
            want = experts[k].state_dict()
            res[(kind, "same_bytes", k)] = all(
                torch.equal(_bytes(sel[n]), _bytes(want[n])) for n in want)
            with torch.no_grad():
                res[(kind, k)] = _np(functional_call(shell, sel, tuple(args)))
        res[(kind, "local_lead")] = next(iter(stack.local.values())).shape[0]
    return res
