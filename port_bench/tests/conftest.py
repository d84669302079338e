"""Shared helpers of the benchmark's CPU tests: every cell shrunk to a size
a test run holds (a few hundred nodes, a short backlog, seconds of traffic)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from port_bench import harness  # noqa: E402

SMALL_NODES = 400


def shrink(data: dict, kind: str) -> dict:
    if kind == "configs":
        data["cluster"]["nodes"] = SMALL_NODES
    elif kind == "workloads":
        if "window" in data["traffic"]:
            data["traffic"].update(window=8, apps_per_group=32)
        data["traffic"].update(
            backlog=24, warmup_s=0.5, warmup_executors=8, queues=2,
            sample_chains=2, warmup_chains=1, profile_s=0.3, profile_windows=2)
    return data


@pytest.fixture
def small(monkeypatch):
    """Cells at a size a CPU test holds, on one CPU thread a worker."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield from _small(monkeypatch)
    torch.set_num_threads(threads)


def _small(monkeypatch):
    load = harness.load_json
    monkeypatch.setattr(harness, "load_json",
                        lambda kind, name: shrink(load(kind, name), kind))
    yield
