"""Seeded generators of the benchmark's inputs: the cluster and the app
mix. NumPy and the standard library only, so the plain reference shares
them with the drivers without loading the program.

The cluster's node shapes and the apps' requests are tables in the
configuration and the cell's file, each row taken from a public source
named beside it there; the generators only draw rows from those tables.
"""

from __future__ import annotations

import numpy as np

INT32_INF = 2**31 - 1


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """One independent stream per (seed, stream ids). Any whole seed, of
    either sign and of any size, maps onto a 64-bit entropy word."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % 2**64, *stream])
    )


def blocks(rng: np.random.Generator, shares: list[int], n: int) -> np.ndarray:
    """n row indices of a table whose rows have whole `shares`: every block
    of sum(shares) consecutive draws holds each row `share` times, in an
    order the generator shuffles. Every seed gets the same work in another
    order, and no stretch holds more of one row than another."""
    base = np.repeat(np.arange(len(shares)), shares)
    reps = -(-n // len(base))
    return np.concatenate([rng.permutation(base) for _ in range(reps)])[:n]


# -------------------------------------------------------------- clusters


def cluster(spec: dict) -> dict:
    """The configuration's cluster: `nodes` nodes named node-00000..., node
    i in zone i % `zones`, each an instance type of `spec["instance_types"]`
    drawn in blocks by its share from the configuration's own `seed`.
    """
    types = spec["instance_types"]
    n = int(spec["nodes"])
    kind = blocks(rng_for(int(spec["seed"]), 0), [t["share"] for t in types], n)
    cpu = np.array([t["vcpu"] for t in types], np.int64)[kind]
    gib = np.array([t["memory_gib"] for t in types], np.int64)[kind]
    gpu = np.array([t["gpu"] for t in types], np.int64)[kind]
    return {
        "names": [f"node-{i:05d}" for i in range(n)],
        "zone": np.arange(n) % int(spec["zones"]),
        "cores": cpu, "gib": gib, "gpus": gpu, "type": kind,
    }


def queue_fields(cl: dict) -> list:
    """A cluster as the program's queue path takes it: the nine fields in
    its order (available, schedulable, zone, name rank, driver and executor
    label ranks, unschedulable, ready, valid), int32 in milli-CPU, MiB and
    GPUs, so that a zone's total stays inside int32."""
    n = len(cl["names"])
    avail = np.stack([cl["cores"] * 1000, cl["gib"] << 10, cl["gpus"]],
                     axis=1).astype(np.int32)
    return [
        avail, avail.copy(), cl["zone"].astype(np.int32),
        np.arange(n, dtype=np.int32),
        np.full(n, INT32_INF, np.int32), np.full(n, INT32_INF, np.int32),
        np.zeros(n, bool), np.ones(n, bool), np.ones(n, bool),
    ]


# --------------------------------------------------------------- the apps


def apps(rng: np.random.Generator, table: list[dict], n: int) -> dict:
    """n apps drawn in blocks from the cell's app table: per app the
    driver's and each executor's CPU (milli) and memory (MiB) and the
    executor count."""
    kind = blocks(rng, [a["share"] for a in table], n)

    def col(key):
        return np.array([a[key] for a in table], np.int64)[kind]

    return {
        "kind": kind,
        "driver_cpu_m": col("driver_cpu_m"), "driver_mem_mib": col("driver_mem_mib"),
        "exec_cpu_m": col("executor_cpu_m"), "exec_mem_mib": col("executor_mem_mib"),
        "executors": col("executors"),
    }


def queue_apps(mix: dict) -> tuple:
    """Apps as the queue path takes them: (driver [n,3], executor [n,3],
    count [n]) int32 in milli-CPU, MiB and GPUs."""
    zero = np.zeros_like(mix["driver_cpu_m"])
    driver = np.stack([mix["driver_cpu_m"], mix["driver_mem_mib"], zero], 1)
    execs = np.stack([mix["exec_cpu_m"], mix["exec_mem_mib"], zero], 1)
    return (driver.astype(np.int32), execs.astype(np.int32),
            mix["executors"].astype(np.int32))
