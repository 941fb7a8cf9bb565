"""A tiny configuration and traffic for running the harness on the CPU: the
same code paths as a chip run (the port's plain kernel versions and its
eager search loop), at sizes a test holds."""

import copy
import json
import os

from gitbench import spec

HERE = os.path.dirname(os.path.abspath(__file__))


def tiny_config(name):
    cfg = spec.read_json(os.path.join(spec.HERE, "configs", name + ".json"))
    cfg.update(model_name="TINY", encoder_width=32, encoder_layers=2, encoder_heads=2,
               visual_feature_size=32, hidden_size=32, num_layers=2, num_heads=2,
               feedforward_size=64, batch_size=4)
    if cfg.get("test_respect_ratio_max"):
        cfg.update(test_crop_size=28, test_respect_ratio_max=42)
    else:
        cfg.update(test_crop_size=28)
    return cfg


TINY_TRAFFIC = {
    "coco_tsv": dict(payloads=8, rows=16),
    "vqa_tsv": dict(images=4, questions_per_image={"1": 1, "2": 1}),
    # two gloo CPU ranks of 2 rows: the engine's batch of 4, as the tiny configurations'
    "coco_tsv_dp4": dict(payloads=8, rows=16, mesh_shape=[2, 1], rows_per_rank=2),
}


def tiny_bench(tmp):
    """BENCHMARK.json's cells on tiny configurations written under tmp, and
    the traffic files cut to tiny sizes: (bench, {traffic name: spec})."""
    bench = copy.deepcopy(spec.load())
    for c in bench["configs"]:
        path = os.path.join(str(tmp), c["name"] + ".json")
        with open(path, "w") as f:
            json.dump(tiny_config(c["name"]), f)
        c["file"] = path
    traffic = {}
    for w in bench["workloads"]:
        t = spec.traffic(w["traffic"])
        t.update(TINY_TRAFFIC.get(w["traffic"], {}))
        traffic[w["traffic"]] = t
    return bench, traffic
