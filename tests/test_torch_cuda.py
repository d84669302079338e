"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc; without them they skip (a CUDA
kernel has no interpret mode). On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerance: none. The window kernel's outputs are integers, and its
single-AZ zone scores are summed in float64 and rounded once, exactly as the
plain version does, so every output must be identical.
"""

import numpy as np
import pytest
import torch

STRATEGIES = (
    "tightly-pack",
    "distribute-evenly",
    "minimal-fragmentation",
    "single-az-tightly-pack",
    "single-az-minimal-fragmentation",
    "az-aware-tightly-pack",
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run on the card only")
    from spark_scheduler_tpu_torch.ops._build import nvcc_path

    try:
        nvcc_path()
    except RuntimeError:
        pytest.skip("no nvcc: the port's kernels build from source")
    return torch.device("cuda", 0)


def test_probe_kernel(cuda_device):
    from spark_scheduler_tpu_torch.ops.probe import probe, probe_add_one

    before = probe_add_one.launches
    probe(cuda_device)
    assert probe_add_one.launches == before + 1


@pytest.mark.parametrize("fill", STRATEGIES)
def test_window_kernel_matches_plain(cuda_device, fill):
    from spark_scheduler_tpu_torch.models.cluster import cluster_from_numpy
    from spark_scheduler_tpu_torch.models.resources import INT32_INF
    from spark_scheduler_tpu_torch.ops.window import (
        make_segmented_window,
        window_pack,
        window_pack_reference,
    )

    rng = np.random.default_rng(5)
    n, emax = 300, 8
    avail = rng.integers(0, 24, size=(n, 3)).astype(np.int32)
    avail[:, 2] = rng.integers(0, 3, size=n)
    cluster = cluster_from_numpy(
        [avail, avail.copy(), rng.integers(0, 4, size=n).astype(np.int32),
         rng.permutation(n).astype(np.int32),
         np.full(n, INT32_INF, np.int32), np.full(n, INT32_INF, np.int32),
         rng.random(n) < 0.1, rng.random(n) > 0.05, np.ones(n, bool)],
        device=cuda_device,
    )
    requests = [
        [(rng.integers(0, 5, 3).astype(np.int32) * [1, 1, 0],
          rng.integers(1, 4, 3).astype(np.int32),
          int(rng.integers(0, emax + 1)), bool(rng.random() < 0.3))
         for _ in range(int(rng.integers(1, 6)))]
        for _ in range(6)
    ]
    masks = [rng.random(n) < 0.9 for _ in requests]
    win = make_segmented_window(requests, masks, [np.ones(n, bool)] * 6)
    before = window_pack.launches
    got = window_pack(cluster, win, fill=fill, emax=emax, num_zones=4)
    torch.cuda.synchronize()
    assert window_pack.launches == before + len(requests)
    want = window_pack_reference(cluster, win, fill=fill, emax=emax,
                                 num_zones=4)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
