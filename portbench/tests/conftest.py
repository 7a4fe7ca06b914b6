"""Shared helpers of the benchmark's tests: its own modules and the port on
the path, a card fixture, and a whole cell shrunk to run on the CPU.

    python -m pytest portbench/tests          # CPU; tests marked cuda skip
    python -m pytest portbench/tests -m cuda  # on a card
"""
import copy
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent / "src"))

from harness.spec import Cell, find_cell  # noqa: E402


@pytest.fixture
def card():
    """The first CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


TINY = {"hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
        "num_key_value_heads": 2, "num_hidden_layers": 2, "vocab_size": 512,
        "rms_norm_eps": 1e-5, "rope_theta": 10000.0, "hidden_act": "silu",
        "tie_word_embeddings": False}


def tiny_cell(name: str, *, batch=None) -> Cell:
    """The cell ``name`` of BENCHMARK.json with every width of its model and
    every length of its traffic cut to run on the CPU in seconds."""
    real = find_cell(name)
    config = copy.deepcopy(real.config)
    cut = dict(TINY)
    if "num_local_experts" in config["config"]:
        cut.update(num_local_experts=4, num_experts_per_tok=2, sliding_window=None)
    config["config"] = cut
    config["reduced"], config["published"] = [], {}
    traffic = copy.deepcopy(real.traffic)
    traffic["engine"].update(prompt_tokens=16, decode_tokens=8, decode_chunk_tokens=4)
    traffic["drain_timeout_s"] = 30
    for stream in traffic["streams"]:
        if batch is not None:
            stream["batch"] = batch
        if stream["kind"] == "poisson":
            stream["rate_per_s"] = 4.0
    traffic["trace"] = {"start_s": 0.2, "seconds": 0.5}
    limits = copy.deepcopy(real.limits)
    limits["sample_per_group"] = 2
    return Cell(name=name, config=config, traffic=traffic, limits=limits, chips=1,
                end_to_end=real.end_to_end, per_layer=real.per_layer)


def run_tiny(cell: Cell, seed: int = 20260419, seconds: float = 2.0, fault=None,
             trace: bool = False) -> dict:
    from harness.cell import run_cell

    return run_cell(cell, seed, seconds, trace, "cpu", time.monotonic(), fault=fault)
