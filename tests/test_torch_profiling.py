"""The port's profiling utilities (`utils/profiling.py`) against the JAX
package's: `dit_matmul_flops` equal for the Wan2.1 1.3B and 14B at the
edit's 29,640 and the 4x edit's 107,640 tokens, the timer's records
(`test_timer_records`), their jsonl dump and reset, and the trace context
writing a Chrome trace."""

import json

import pytest
import torch

from videocof_torch import configs
from videocof_torch.utils import profiling

torch.set_num_threads(1)


@pytest.mark.parametrize("tokens", [29_640, 107_640])
@pytest.mark.parametrize("name", ["WAN21_T2V_1_3B", "WAN21_T2V_14B"])
def test_dit_matmul_flops_matches_jax(name, tokens):
    from videocof_tpu import configs as jconfigs
    from videocof_tpu.utils import profiling as jprof
    want = jprof.dit_matmul_flops(getattr(jconfigs, name), tokens)
    assert profiling.dit_matmul_flops(getattr(configs, name), tokens) == want
    assert profiling.dit_matmul_flops(getattr(configs, name), tokens,
                                      text_len=226) == \
        jprof.dit_matmul_flops(getattr(jconfigs, name), tokens, text_len=226)


def test_timer_records(tmp_path):
    profiling.reset_records()

    @profiling.timer(name="toy")
    def f(x):
        return x * 2

    assert torch.equal(f(torch.ones(4)), torch.full((4,), 2.0))
    recs = profiling.records()
    assert len(recs) == 1 and recs[0]["name"] == "toy"
    assert recs[0]["seconds"] >= 0

    @profiling.timer
    def g():
        return 3

    assert g() == 3
    assert [r["name"] for r in profiling.records()] == [
        "toy", "test_timer_records.<locals>.g"]
    path = tmp_path / "timings.jsonl"
    profiling.dump_records(str(path))
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["name"] for r in rows] == ["toy",
                                         "test_timer_records.<locals>.g"]
    profiling.reset_records()
    assert profiling.records() == []


def test_unrecorded_timer_keeps_no_record():
    profiling.reset_records()
    profiling.timer(lambda: None, name="quiet", record=False)()
    assert profiling.records() == []


def test_torch_trace_writes_a_chrome_trace(tmp_path):
    with profiling.torch_trace(str(tmp_path), "t.json") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof.key_averages()
    trace = json.loads((tmp_path / "t.json").read_text())
    assert trace["traceEvents"]
