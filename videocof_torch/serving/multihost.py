"""Multi-worker serving and multi-process initialization.

Counterpart of `videocof_tpu/serving/multihost.py`. The reference fans
requests over `@ray.remote(num_gpus=1)` actors that each own a pipeline
(`videox_fun/api/api_multi_nodes.py:75-98,262+`); here:

  * `init_distributed()` starts `torch.distributed` from JAX's variables
    (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID) or arguments, over
    ``tcp://``, with NCCL on CUDA and gloo on the CPU unless the caller
    names the backend; with none of them it takes ``env://`` (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK: ``torch.distributed.run``'s).
  * `WorkerPool` fans a batch of requests over N HTTP workers (each a
    `serving.api` process on its own card or host), each worker taking the
    next request when it is free, with retries: the serving side of the
    CLI's ``pending[rank::world]`` sharding.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import urllib.request
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import torch


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """`torch.distributed.init_process_group` for this process: the
    coordinator ("host:port", or a ``tcp://`` URL), the world size and this
    process's rank from the arguments or from COORDINATOR_ADDRESS,
    NUM_PROCESSES and PROCESS_ID; ``backend`` (default NCCL when CUDA is
    present, else gloo; NCCL refuses two ranks on one card, which gloo
    serves)."""
    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("NUM_PROCESSES"):
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and os.environ.get("PROCESS_ID"):
        process_id = int(os.environ["PROCESS_ID"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if not (coordinator or num_processes or process_id is not None):
        torch.distributed.init_process_group(backend, init_method="env://")
        return
    if not coordinator or num_processes is None or process_id is None:
        raise ValueError(
            "init_distributed needs the coordinator address, the number of "
            "processes and this process's id together (arguments or "
            "COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID)")
    if "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    torch.distributed.init_process_group(
        backend, init_method=coordinator, world_size=int(num_processes),
        rank=int(process_id))


@dataclass
class WorkerPool:
    """Request fan-out over serving.api workers."""

    endpoints: Sequence[str]          # e.g. ["http://host1:8188", ...]
    timeout: float = 900.0
    max_retries: int = 2

    def _post(self, endpoint: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        from .api import ENDPOINT
        req = urllib.request.Request(
            endpoint.rstrip("/") + ENDPOINT,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.load(r)

    def healthy(self) -> List[str]:
        """The endpoints whose /healthz answers "ok"."""
        ok = []
        for ep in self.endpoints:
            try:
                with urllib.request.urlopen(ep.rstrip("/") + "/healthz",
                                            timeout=5) as r:
                    if json.load(r).get("status") == "ok":
                        ok.append(ep)
            except Exception:
                pass            # down, degraded or not a server: not healthy
        return ok

    def map(self, payloads: Sequence[Dict[str, Any]]
            ) -> List[Dict[str, Any]]:
        """The replies to ``payloads``, in order: one thread per worker,
        each posting the next waiting payload (a worker serializes its own
        generations); a payload failing ``max_retries + 1`` times gets
        ``{"message": "error: ..."}``."""
        results: List[Optional[Dict]] = [None] * len(payloads)
        work: "queue.Queue" = queue.Queue()
        for i in range(len(payloads)):
            work.put(i)

        def run(worker_ep: str):
            while True:
                try:
                    i = work.get_nowait()
                except queue.Empty:
                    return
                last_err = None
                for _ in range(self.max_retries + 1):
                    try:
                        results[i] = self._post(worker_ep, payloads[i])
                        last_err = None
                        break
                    except Exception as e:  # retried, then reported
                        last_err = e
                if last_err is not None:
                    results[i] = {"message": f"error: {last_err}"}

        threads = [threading.Thread(target=run, args=(ep,))
                   for ep in self.endpoints]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return results  # type: ignore
