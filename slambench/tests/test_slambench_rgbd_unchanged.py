"""The RGB-D cells are untouched by the stereo path: at a fixed seed their
tiny sequences hash, and their tiny runs' check numbers and PSNR read, as
they did before the harness learned stereo (values recorded from that
tree, on the CPU with one intra-op thread, where a run repeats bit for
bit)."""

import hashlib

import numpy as np
import pytest
import torch

from slambench.lib import catalog
from slambench.lib.scene import load_scene
from slambench.lib.sequence import camera_from_config, make_sequence
from slambench.tests.tiny import cpu_run, short_init, tiny_root

SEED = 2**31 + 12345
DIGESTS = {
    "tum1.desk": "3ab056225dda9a862387f07af7c0c6812cf1eb153f412bdc2df414b26fa9f5f3",
    "replica.room0": "a4e6e6c9f8503789c7f7390346493aa9beb9c20c5194e8c1c7f5820272d9d7c5",
}
NUMBERS = {
    "tum1.desk": {"frontend": 8.537159712496134e-08, "track": 3.3330172795381974e-05,
                  "map": 2.3446749764843844e-05, "render": 4.785273404195323e-07,
                  "psnr_db": 23.28417938063763},
    "replica.room0": {"frontend": 8.293744890863763e-08, "track": 5.5985078688536305e-06,
                      "map": 2.1159203242859803e-05, "render": 4.030176512515027e-07,
                      "psnr_db": 24.23464651176935},
}


def sequence_digest(root, cell: str) -> str:
    bench = catalog.load_benchmark(root)
    w = catalog.workload(bench, cell)
    cfg, tr = catalog.config(root, w["config"]), catalog.traffic(root, w["traffic"])
    seq = make_sequence(load_scene(catalog.scene_path(root, tr["scene"])),
                        camera_from_config(cfg["system"]), tr, SEED, torch.device("cpu"))
    assert seq.rights is None
    h = hashlib.sha256()
    for a in (seq.colors, seq.depths, seq.T_cw, seq.timestamps):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("cell", sorted(DIGESTS))
def test_sequence_is_unchanged(tmp_path, cell):
    assert sequence_digest(tiny_root(tmp_path, cell), cell) == DIGESTS[cell]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", sorted(NUMBERS))
def test_check_numbers_are_unchanged(tmp_path, monkeypatch, one_thread, cell):
    short_init(monkeypatch)
    res = cpu_run(tiny_root(tmp_path, cell), cell, seed=SEED)
    got = {k: c["value"] for k, c in res["checks"].items()}
    got["psnr_db"] = res["metrics"]["psnr_db"]["value"]
    assert got == NUMBERS[cell]
