"""The harness rehearsed on the CPU: a tiny configuration and mixes added
as files to a copy of the benchmark run through the window, the metric
readers, the last line and the comparison with the reference (the whole
trajectory, or one step and the sampler); so does a second family added
as files; an addition edits no file that was there; and `run.py` without
a card exits non-zero with no result."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

from cofbench.tests import tiny, toy
from cofbench.tests.conftest import digests, measure

ROOT = Path(__file__).resolve().parents[2]


def test_addition_edits_no_existing_file(checkout):
    root, before = checkout
    after = digests(root)
    changed = {k for k in before if after.get(k) != before[k]}
    assert changed == {"BENCHMARK.json"}


def test_untraced_run_reports_end_to_end_and_check(checkout):
    root, _ = checkout
    result, lines = measure(root, traced=False)
    assert set(result) == {"correct", "attempted", "failed", "metrics",
                           "device", "check"}
    assert list(result)[-1] == "check"
    assert set(result["metrics"]) == {"edit_s", "peak_gb", "setup_s"} - {
        "peak_gb"}          # no device memory to read on the CPU
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["correct"], result["check"]
    assert set(result["check"]) == {"text_rel_l2", "source_rel_l2",
                                    "latent_rel_l2", "frame_rms",
                                    "edit_rel_l2", "malformed_edits"}
    assert all("limit" in v for v in result["check"].values())
    assert any("frame_rms" in line for line in lines)
    json.dumps(result)


def test_traced_run_reads_the_added_metric(checkout):
    root, _ = checkout
    result, _ = measure(root, traced=True)
    metrics = result["metrics"]
    assert metrics["edits_done"]["value"] == result["attempted"]
    assert metrics["dit_step_s"]["value"] > 0
    assert metrics["vae_s"]["value"] > 0
    # no device trace on the CPU: the device readers stay silent
    for name in ("attn_roofline", "gemm_roofline", "dit_other_ms"):
        assert name not in metrics
    assert "breakdown" in result and result["correct"]


def test_run_without_a_card_exits_nonzero_with_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, str(ROOT / "cofbench" / "run.py"),
                          "--workload", "wan14b.cof_edit", "--seed",
                          "3000000001", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "no result" in res.stderr


def test_the_step_cell_holds_one_step_and_the_sampler(checkout):
    root, _ = checkout
    result, lines = measure(root, traced=False, cell=tiny.STEP_CELL)
    assert result["correct"], result["check"]
    assert set(result["check"]) == {"text_rel_l2", "source_rel_l2",
                                    "step_rel_l2", "sampler_rel_l2",
                                    "frame_rms", "malformed_edits"}
    assert any("step_rel_l2" in line for line in lines)


def test_a_family_added_as_files_runs_through_measure(toy_checkout):
    root, before = toy_checkout
    after = digests(root)
    assert {k for k in before if after.get(k) != before[k]} == {
        "BENCHMARK.json"}
    result, _ = measure(root, traced=False, cell=toy.CELL)
    assert result["correct"], result["check"]
    assert set(result["check"]) == {"toy_rel_l2", "malformed_edits"}
    assert set(result["metrics"]) == {"edit_s", "setup_s"}
    result, _ = measure(root, traced=True, cell=toy.CELL)
    assert result["correct"], result["check"]
    # the stage walls the toy's units give; no device trace on the CPU
    assert set(result["metrics"]) == {"dit_step_s"}
