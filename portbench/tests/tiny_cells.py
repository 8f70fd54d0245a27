"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds, for the
harness's CPU tests: 16 mel bins at 3.2 kHz, 1 s clips, four conv blocks
(the folded stem's first three keep their 128-lane widths), H = 16."""
from __future__ import annotations

import copy
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def tiny(config, mix):
    config, mix = copy.deepcopy(config), copy.deepcopy(mix)
    config["audio"].update(sr=3200, n_window=256, hop_size=80, n_mels=16,
                           mel_f_max=1600.0, max_len_seconds=1.0)
    config["model"].update(nb_filters=[16, 32, 64, 16],
                           pooling=[[2, 2], [2, 2], [1, 2], [1, 2]],
                           n_rnn_cell=16)
    mix["audio"].update(freq_hz=[100, 1400], sweep_hz_per_s=300,
                        event_s=[0.1, 0.5])
    from portbench.harness import cell
    mix.update(copy.deepcopy(cell.runner_module(mix["runner"]).TINY))
    return config, mix


def run(workload: str, seed: int = 2 ** 31 + 11, seconds: float = 0.5,
        **kw):
    """One tiny run of ``workload`` on the CPU; returns the result."""
    import torch
    from portbench.harness import cell
    torch.set_num_threads(2)
    return cell.execute(ROOT, workload, seed, seconds, False, device="cpu",
                        require_card=False, overrides=tiny, log=lambda s: None,
                        **kw)
