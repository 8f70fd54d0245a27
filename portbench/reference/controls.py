"""The control of a cell: the reference put in the program's place at the
nearest precision below the one the configuration states.

bfloat16 → fp8 e4m3 operands; float32 whose entry keeps TF32 off (the
mix's ``entry_tf32`` false) → the same reference with TF32 on; other
float32 → bfloat16 operands."""
from __future__ import annotations

from typing import Mapping

from portbench.reference import quant


class Control:
    def __init__(self, name: str, q, tf32: bool):
        self.name, self.q, self.tf32 = name, q, tf32


def control_for(config: Mapping, mix: Mapping) -> Control:
    precision = mix.get("compute_dtype", config["precision"][mix["runner"]])
    if precision == "bfloat16":
        return Control("fp8", quant.fp8, False)
    if not mix.get("entry_tf32", True):
        return Control("tf32", quant.identity, True)
    return Control("bf16", quant.bf16, False)
