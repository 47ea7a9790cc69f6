"""Chain-of-frames trainer, on one device or over a mesh of ranks.

Counterpart of `videocof_tpu/training/trainer.py`: dataset triplets ->
frozen-VAE latents in the CoF layout [src | ground | tgt] -> frozen-umT5 text
embeddings -> masked flow-matching loss (source frames stay clean, as in the
edit) -> one training step (LoRA adapters over a frozen base, or full
fine-tuning), with block remat -> a train-state checkpoint every
``save_every`` steps (`utils.checkpoint.save_train_state`).

With ``mesh_data * mesh_seq > 1`` it runs in every rank of a
`torch.distributed` world of that size (`parallel.make_mesh`): each step
takes the global batch of ``batch_size`` samples from the iterator on
every rank, and each data rank prepares and trains on its own rows; the
ranks of a seq group share their rows and run the DiT forward
sequence-parallel (Ulysses). In LoRA mode the frozen base is sharded over
``data`` with FSDP (JAX's `trainer.py:74-80`); a full fine-tune shards its
parameters and optimizer state. Timesteps: the rows of data rank d are
drawn from band d of ``mesh_data`` bands, the reference's one band per
data-parallel rank; JAX draws every row with its
process index, so a single-process JAX mesh draws all of them from band 0
(the stated departure, ROADMAP.md §A). Every rank draws every band's
timesteps and the global batch's noise from one seeded generator, so the
ranks of a group share them, and a one-process trainer whose ``sampler``
has ``mesh_data`` bands repeats the draws. Only rank 0 logs and writes.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..data.tokenizer import WanTokenizer
from ..models.t5_encoder import T5Encoder
from ..models.wan_dit import WanDiT, make_rope_for_geometry
from ..models.wan_vae import WanVAE
from ..parallel import apply_fsdp, make_mesh
from ..pipeline.wan_pipeline import (_resolve_device, _to_host,
                                     latent_frame_count, run_t5)
from ..utils import checkpoint
from .timestep_sampler import DiscreteSampling
from .train_step import (StageTimer, adamw, make_lora_train_step,
                         make_train_step)


@dataclass
class TrainerConfig:
    height: int = 480
    width: int = 832
    source_frames: int = 33
    target_frames: int = 33
    reasoning_frames: int = 4
    batch_size: int = 1
    total_steps: int = 1000
    learning_rate: float = 1e-5
    weight_decay: float = 1e-3
    grad_clip: float = 0.05          # reference ZeRO configs clip at 0.05
    mesh_data: int = 1
    mesh_seq: int = 1
    log_every: int = 10
    save_every: int = 500
    checkpoint_dir: Optional[str] = None
    seed: int = 0
    # LoRA mode (the reference's own 14B training regime): train only rank-r
    # adapters over a frozen base; None = full fine-tuning
    lora_rank: Optional[int] = None


class CoFTrainer:
    """``CoFTrainer(dit, vae, t5, tokenizer, tcfg, device=None,
    offload_t5=False)``: the models move to ``device`` (CUDA unless
    ``device="cpu"``; raises without a GPU), VAE and T5 frozen;
    ``offload_t5`` keeps umT5's weights in host memory (pinned with CUDA)
    and runs it on transient device copies in each batch's preparation, as
    the pipeline's ``offload_t5`` does. ``train(sample_iter)`` runs the
    loop."""

    def __init__(self, dit: WanDiT, vae: WanVAE, t5: T5Encoder,
                 tokenizer: Optional[WanTokenizer], tcfg: TrainerConfig,
                 device=None, offload_t5: bool = False):
        self.device = _resolve_device(device)
        self.mesh, self.data_rank = None, 0
        if tcfg.mesh_data * tcfg.mesh_seq > 1:
            if tcfg.batch_size % tcfg.mesh_data:
                raise ValueError(f"batch_size {tcfg.batch_size} does not "
                                 f"divide over {tcfg.mesh_data} data ranks")
            self.mesh = make_mesh(data=tcfg.mesh_data, seq=tcfg.mesh_seq,
                                  device_type=self.device.type)
            self.data_rank = self.mesh.get_local_rank("data")
        self.is_main = (not torch.distributed.is_initialized()
                        or torch.distributed.get_rank() == 0)
        self.dit = dit.to(self.device)
        self.vae = vae.to(self.device).requires_grad_(False)
        self.t5 = (_to_host(t5) if offload_t5 else t5.to(self.device)
                   ).requires_grad_(False)
        self.tokenizer = tokenizer or WanTokenizer(vocab_size=t5.cfg.vocab)
        self.tcfg = tcfg
        self.losses: List[float] = []

        tx = adamw(tcfg.learning_rate, tcfg.weight_decay, tcfg.grad_clip)
        if tcfg.lora_rank:
            init_fn, self.step_fn = make_lora_train_step(
                self.dit, tx, rank=tcfg.lora_rank, mesh=self.mesh)
            if self.mesh is not None:
                apply_fsdp(self.dit, self.mesh)        # the frozen base
            gen = torch.Generator(device=self.device).manual_seed(tcfg.seed + 1)
            self.state = init_fn(gen)
        else:
            init_fn, self.step_fn = make_train_step(self.dit, tx,
                                                    mesh=self.mesh)
            self.state = init_fn()
        # one timestep band per data rank
        self.sampler = DiscreteSampling(group_num=tcfg.mesh_data)
        # timesteps and noise; successive `train` calls continue its stream
        self.generator = torch.Generator(device=self.device).manual_seed(
            tcfg.seed)

        # static CoF geometry
        tc = vae.cfg.temporal_compression_ratio
        self.f_src = latent_frame_count(tcfg.source_frames, tc)
        self.f_ground = latent_frame_count(tcfg.reasoning_frames, tc)
        self.f_tgt = latent_frame_count(tcfg.target_frames, tc)
        self.f_total = self.f_src + self.f_ground + self.f_tgt

    # ----------------------------------------------------------- preparation
    @torch.no_grad()
    def prepare_batch(self, samples) -> Dict[str, Any]:
        """List of dataset dicts (``pixel_src``, ``pixel_ground``,
        ``pixel_tgt`` [3, T, H, W] in [-1, 1], ``text``) -> device batch:
        latents ``x0`` (mu of each segment, encoded separately so each
        starts causally), ``context`` (umT5, zeroed past each prompt),
        the CoF RoPE tables and the frame mask (source = 0)."""
        pix = np.stack([np.concatenate(
            [s["pixel_src"], s["pixel_ground"], s["pixel_tgt"]], axis=1)
            for s in samples])                     # [B, 3, T_pix, H, W]
        pix = torch.as_tensor(pix, device=self.device)
        vdtype = next(self.vae.parameters()).dtype
        src_px = self.tcfg.source_frames
        grd_px = self.tcfg.reasoning_frames
        parts = [self.vae.encode(pix[:, :, lo:hi].to(vdtype))[0]
                 for lo, hi in ((0, src_px), (src_px, src_px + grd_px),
                                (src_px + grd_px, pix.shape[2]))]
        x0 = torch.cat(parts, dim=2).float()       # [B, C, f_total, h, w]

        ids, mask = self.tokenizer([s["text"] for s in samples],
                                   max_length=self.dit.cfg.text_len)
        ids = torch.as_tensor(ids, device=self.device)
        mask = torch.as_tensor(mask, device=self.device)
        ctx = run_t5(self.t5, ids, mask).float() * mask[..., None].float()

        ph, pw = self.dit.cfg.patch_size[1:]
        cos, sin = make_rope_for_geometry(
            self.dit.cfg, (self.f_total, x0.shape[3] // ph, x0.shape[4] // pw),
            f_src=self.f_src, f_ground=self.f_ground)
        frame_mask = torch.ones(self.f_total, device=self.device)
        frame_mask[: self.f_src] = 0.0             # source stays clean
        return {
            "x0": x0,
            "context": ctx,
            "rope_cos": torch.as_tensor(cos, device=self.device),
            "rope_sin": torch.as_tensor(sin, device=self.device),
            "frame_mask": frame_mask,
        }

    # ------------------------------------------------------------------ loop
    def train(self, sample_iter: Iterator, total_steps: Optional[int] = None,
              timings: Optional[List[Dict[str, float]]] = None):
        """Run ``total_steps`` steps (``tcfg.total_steps`` by default) and
        return the state. Losses go to ``self.losses``. With a
        ``checkpoint_dir``, the state is saved after every step whose count
        (``state.step``, which a restored state carries on) is a multiple
        of ``save_every``. A list passed as
        ``timings`` receives one dict of stage walls per step: "prepare",
        "forward+backward", "optimizer" (the device is synchronized at each
        stage boundary only then)."""
        tcfg = self.tcfg
        total_steps = total_steps or tcfg.total_steps
        t_start = time.time()
        rows = tcfg.batch_size // tcfg.mesh_data    # this data rank's
        mine = slice(self.data_rank * rows, (self.data_rank + 1) * rows)
        for step in range(total_steps):
            stages = None if timings is None else {}
            clock = StageTimer(stages, self.device)
            samples = [next(sample_iter) for _ in range(tcfg.batch_size)]
            batch = self.prepare_batch(samples[mine])
            batch["timesteps"] = self.draw_timesteps()[mine]
            clock.tick("prepare")
            self.state, loss = self.step_fn(self.state, batch,
                                            generator=self.generator,
                                            timings=stages)
            self.losses.append(float(loss))
            if timings is not None:
                timings.append(stages)
            if step % tcfg.log_every == 0 and self.is_main:
                print(f"[train] step {step} loss {self.losses[-1]:.4f} "
                      f"({time.time() - t_start:.0f}s)", file=sys.stderr,
                      flush=True)
            if (tcfg.checkpoint_dir and tcfg.save_every
                    and self.state.step % tcfg.save_every == 0):
                checkpoint.save_train_state(tcfg.checkpoint_dir, self.state)
                if self.is_main:
                    print(f"[train] checkpoint @ step {self.state.step}",
                          file=sys.stderr)
        return self.state

    def draw_timesteps(self) -> torch.Tensor:
        """The global batch's integer timesteps [batch_size]: its rows split
        into the sampler's ``group_num`` equal runs, run g drawn from band
        g."""
        n, bands = self.tcfg.batch_size, self.sampler.group_num
        if n % bands:
            raise ValueError(f"batch_size {n} does not split into "
                             f"{bands} timestep bands")
        return torch.cat([self.sampler.sample(self.generator, n // bands,
                                              dp_rank=g)
                          for g in range(bands)])
