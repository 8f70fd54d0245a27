"""The check that decides ``correct``, driven through whole runs on the CPU
at a tiny size (``tiny_cells.py``): sound runs pass; runs whose timed
path is broken underneath, and the control (the reference one precision
below the configuration's in the program's place), do not."""
from __future__ import annotations

import pytest
import torch

from portbench.harness import cell
from portbench.reference import controls, quant
from portbench.tests.tiny_cells import ROOT, run, tiny

CELLS = ("serve_crnn_b64", "predict_crnn_wav", "train_crnn_mtisp_perf",
         "train_fpn_mtisp_ref")


def _control(workload):
    """The cell's control; on the CPU, which has no TF32, a TF32 control
    is taken as bfloat16 operands."""
    _, _, config, mix, _ = cell.find(ROOT, workload)
    ctl = controls.control_for(*tiny(config, mix))
    if ctl.tf32:
        ctl = controls.Control("bf16", quant.bf16, False)
    return ctl


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    r = run(workload)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in CELLS
    for f in cell.runner_module(cell.find(ROOT, w)[3]["runner"]).FAULTS])
def test_fault_is_caught(workload, fault):
    r = run(workload, fault=fault)
    assert not r["correct"], (fault.__name__, r["checks"])


# --- the control -------------------------------------------------------------

@pytest.mark.parametrize("workload", CELLS)
def test_control_reads_far_above_the_program(workload):
    """At the tiny size the control's numbers read at least three times
    the program's on the same seed, in one number or more (the card's
    runs at the cell's size set the limits between the two)."""
    prog = run(workload)["checks"]
    ctl = run(workload, control=_control(workload), seconds=1.0)["checks"]
    ratios = {k: ctl[k]["value"] / max(prog[k]["value"], 1e-12)
              for k in prog if prog[k]["limit"] > 0}
    assert max(ratios.values()) >= 3.0, (prog, ctl)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_on_the_card(workload):
    """The control at the cell's own size is not correct (on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs at its own size")
    _, _, config, mix, _ = cell.find(ROOT, workload)
    r = cell.execute(ROOT, workload, 2 ** 31 + 101, 8.0, False,
                     control=controls.control_for(config, mix),
                     log=lambda s: None)
    assert not r["correct"], r["checks"]


def test_traced_run_without_device_work_is_refused():
    """The traced path runs to the trace's reading; on the CPU no
    operation ran on a device, and the run gives no result."""
    torch.set_num_threads(2)
    with pytest.raises(ValueError, match="no device operation"):
        cell.execute(ROOT, "serve_crnn_b64", 2 ** 31 + 3, 2.0, True,
                     device="cpu", require_card=False, overrides=tiny,
                     log=lambda s: None)
