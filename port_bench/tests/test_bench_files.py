"""The benchmark's files: every name BENCHMARK.json gives loads, a dropped-in
configuration, cell or per-layer metric is found with no edit, the
generators repeat per seed, the roofline counts agree with a count by hand,
and a run that loaded JAX or found no card prints no result."""

import json
import shutil
import sys
import time

import numpy as np
import pytest

from port_bench import generators, harness, roofline, run


def test_every_name_in_the_benchmark_loads():
    bench = harness.benchmark()
    for c in bench["configs"]:
        cfg = harness.load_json("configs", c["name"])
        assert c["file"] == f"port_bench/configs/{c['name']}.json"
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        cell = harness.load_json("workloads", w["name"])
        assert cell["config"] == w["config"] and cell["why"] == w["why"]
        assert hasattr(harness.load_module("drivers", cell["driver"]), "Driver")
    for m in bench["per_layer"]:
        assert harness.load_module("metrics", m["name"]).read(None) is None


def available(kind: str) -> list[str]:
    """Names of every file of one kind in the harness's folders."""
    suffix = ".py" if kind in ("drivers", "metrics") else ".json"
    return sorted(p.name[: -len(suffix)] for p in (harness.HERE / kind).iterdir()
                  if p.name.endswith(suffix))


def test_the_folders_hold_what_the_benchmark_names():
    bench = harness.benchmark()
    assert available("configs") == sorted(c["name"] for c in bench["configs"])
    assert available("workloads") == sorted(w["name"] for w in bench["workloads"])
    assert available("metrics") == sorted(m["name"] for m in bench["per_layer"])
    layers = {m["layer"] for m in bench["per_layer"]}
    assert all(m["moves"] in {e["name"] for e in bench["end_to_end"]}
               for m in bench["per_layer"]) and layers


def test_a_dropped_in_config_cell_and_metric_are_found(tmp_path, monkeypatch, small):
    """A new configuration, cell and per-layer metric are three new files
    and three new entries; nothing that is there changes."""
    for kind in ("configs", "workloads", "metrics", "drivers"):
        shutil.copytree(harness.HERE / kind, tmp_path / kind)
    cfg = json.loads((tmp_path / "configs/spark-10k-tightly-pack.json").read_text())
    cfg["name"] = "spark-dropped-in"
    (tmp_path / "configs/spark-dropped-in.json").write_text(json.dumps(cfg))
    cell = json.loads((tmp_path / "workloads/queue-10k-w100.json").read_text())
    cell["config"] = "spark-dropped-in"
    (tmp_path / "workloads/queue-dropped-in.json").write_text(json.dumps(cell))
    (tmp_path / "metrics/windows_traced.queue.py").write_text(
        "def read(records):\n"
        "    return records['windows'] if records else None\n")
    monkeypatch.setattr(harness, "HERE", tmp_path)
    bench = harness.benchmark()
    bench["workloads"].append({"name": "queue-dropped-in", "config": "spark-dropped-in",
                               "traffic": "queue-dropped-in", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "windows_traced.queue", "unit": "windows",
                               "better": "higher", "source": "host_clock",
                               "layer": "queue kernel", "moves": "queue_window_p95_ms",
                               "workloads": ["queue-dropped-in"]})
    monkeypatch.setattr(harness, "benchmark", lambda: bench)
    assert "spark-dropped-in" in available("configs")
    out = run.run_cell("queue-dropped-in", 5, 3.0, True, device="cpu",
                       t_start=time.perf_counter())
    assert out["correct"]
    assert out["metrics"]["windows_traced.queue"]["value"] >= 2


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 9, -4, 2**64 + 3])
def test_generators_repeat_per_seed(seed):
    table = harness.load_json("workloads", "queue-10k-w100")["traffic"]["apps"]
    x = generators.apps(generators.rng_for(seed, 1), table, 40)
    y = generators.apps(generators.rng_for(seed, 1), table, 40)
    assert all(np.array_equal(x[k], y[k]) for k in x)
    z = generators.apps(generators.rng_for(seed + 1, 1), table, 40)
    assert not np.array_equal(x["kind"], z["kind"])
    # Every seed offers the same work in another order.
    assert sorted(x["executors"]) == sorted(z["executors"])


def test_the_cluster_is_the_configurations_own():
    spec = dict(harness.load_json("configs", "spark-10k-tightly-pack")["cluster"],
                nodes=60)
    a, b = generators.cluster(spec), generators.cluster(spec)
    assert all(np.array_equal(a[k], b[k]) for k in ("cores", "gib", "gpus"))
    types = spec["instance_types"]
    assert np.bincount(a["type"], minlength=len(types)).tolist() == [12] * 5
    t = types[int(a["type"][0])]
    assert [int(a["cores"][0]), int(a["gib"][0])] == [t["vcpu"], t["memory_gib"]]
    assert generators.queue_fields(a)[0][0].tolist() == [t["vcpu"] * 1000,
                                                         t["memory_gib"] << 10, 0]


def test_roofline_counts_agree_with_a_count_by_hand():
    # 1,000 nodes, 100 live apps of one queue, emax 8, tightly-pack:
    # 2.4e6 int32 operations against 54,000 bytes; operations bound it.
    t = roofline.queue_kernel_bound(nodes=1000, groups=1, apps=100, live=100,
                                    emax=8, num_zones=4, fill="tightly-pack")
    assert t == pytest.approx(100 * 1000 * 24 / 67e12)
    by_hand_bytes = 1000 * (16 + 18) + 100 * 30 + 100 * 12 * 4 + 200 + 1000 * 12
    assert by_hand_bytes / 3.35e12 < t
    # Single-AZ fills walk each zone: four times the operations.
    t_az = roofline.queue_kernel_bound(nodes=1000, groups=1, apps=100, live=100,
                                       emax=8, num_zones=4,
                                       fill="single-az-tightly-pack")
    assert t_az == pytest.approx(4 * t)
    # Eight queues of 10 apps over 100,000 nodes: the node state and orders
    # (34 bytes a node a queue) outweigh the operations; bytes bound it.
    w = roofline.queue_kernel_bound(nodes=100_000, groups=8, apps=10, live=10,
                                    emax=8, num_zones=4, fill="tightly-pack")
    by_hand = 8 * (100_000 * (34 + 12) + 10 * 30 + 10 * 12 * 4 + 20)
    assert w == pytest.approx(by_hand / 3.35e12)
    assert by_hand / 3.35e12 > 8 * 10 * 100_000 * 24 / 67e12


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: {"correct": True})
    monkeypatch.setitem(sys.modules, "spark_scheduler_tpu_torch_probe", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    rc = run.main(["--workload", "queue-10k-w100", "--seed", "1",
                   "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""
    monkeypatch.delitem(sys.modules, "jax.numpy")
    monkeypatch.setitem(sys.modules, "spark_scheduler_tpu.ops", object())
    assert harness.forbidden_modules() == ["spark_scheduler_tpu"]


def test_a_run_without_a_card_prints_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", "queue-10k-w100", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""
