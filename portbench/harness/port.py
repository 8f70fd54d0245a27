"""The port's configuration of a cell: the preset the configuration file
names for the runner's kind, with every size of the configuration file
written over it, so the file is the configuration as it is run."""
from __future__ import annotations

import dataclasses
from typing import Mapping

AUDIO_KEYS = ("sr", "n_window", "hop_size", "n_mels", "mel_f_min",
              "mel_f_max", "max_len_seconds", "noise_snr")
MODEL_KEYS = ("n_in_channel", "nclass", "activation", "dropout",
              "nb_filters", "pooling", "kernel_size", "n_rnn_cell",
              "n_layers_rnn", "attention", "use_fpn")


def port_config(config: Mapping, kind: str, mix: Mapping):
    """``bsed_tpu_torch.config.Config`` of a cell: the configuration's
    preset for ``kind`` ('serve', 'train', 'predict'), its audio and model
    sizes, the compute dtype the configuration states for ``kind`` (or
    the mix's ``compute_dtype``), and ``perf_config`` where the mix asks
    for the --perf form."""
    from bsed_tpu_torch.config import get_config, perf_config

    cfg = get_config(mix.get("preset", config["presets"][kind]))
    audio = {k: config["audio"][k] for k in AUDIO_KEYS}
    model = {k: config["model"][k] for k in MODEL_KEYS}
    model["nb_filters"] = tuple(model["nb_filters"])
    model["pooling"] = tuple(tuple(p) for p in model["pooling"])
    if model["nclass"] != cfg.nclass:
        raise ValueError(f"nclass {model['nclass']} but the preset lists "
                         f"{cfg.nclass} classes")
    if mix.get("perf"):
        cfg = perf_config(cfg)
    model["compute_dtype"] = mix.get("compute_dtype",
                                     config["precision"][kind])
    return cfg.replace(audio=dataclasses.replace(cfg.audio, **audio),
                       model=dataclasses.replace(cfg.model, **model))
