"""What every cell reads stays what it read when its pin was written:
the leaves, the operations a sample, the record's width and the first
batches of the stream.  A cell's pin is the data file
``pins/<cell>.json`` (the tiny cell's is written with the tiny cell),
so a cell added later brings its pin as a new file."""
import hashlib
import json

import pytest

from esdbench import peaks, weights
from esdbench._tiny import CELL, write_tiny
from esdbench.feed import first_batches
from esdbench.gen import record_width
from esdbench.manifest import HERE, Bench

SEED = 2 ** 31 + 17
CELLS = sorted([c["name"] for c in json.loads(
    (HERE.parent / "BENCHMARK.json").read_text())["workloads"]] + [CELL])


def _sha(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(a.tobytes())
    return h.hexdigest()


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """Each cell's configuration, mix and pin file: the benchmark's and
    the tiny cell's."""
    out = {}
    root = write_tiny(tmp_path_factory.mktemp("tiny"))
    for bench in (Bench(HERE.parent), Bench(root, root)):
        for cell in bench.data["workloads"]:
            out[cell["name"]] = (bench.config(cell["config"]),
                                 bench.mix(cell["traffic"]),
                                 bench.here / "pins" / f"{cell['name']}.json")
    return out


def test_every_cell_is_pinned(cells):
    assert sorted(cells) == CELLS
    assert [name for name, (_, _, pin) in cells.items()
            if not pin.is_file()] == []


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reads_as_before(cells, cell):
    cfg, mix, path = cells[cell]
    pin = json.loads(path.read_text())
    assert weights.leaf_specs(cfg) == [(name, tuple(shape), scale) for
                                       name, shape, scale in
                                       pin["leaf_specs"]]
    assert peaks.model_flops_per_sample(cfg) == \
        pin["model_flops_per_sample"]
    assert record_width(cfg) == pin["record_width"]
    assert _sha(a for batch in first_batches(cfg, mix, pin["seed"],
                                             pin["batches"])
                for a in batch) == pin["stream_sha256"]


def test_tiny_weights_are_as_before(cells):
    cfg, _, _ = cells[CELL]
    w = weights.make_weights(cfg, SEED, "cpu")
    h = hashlib.sha256()
    for name, leaf in w.items():
        h.update(name.encode())
        h.update(leaf.numpy().tobytes())
    assert h.hexdigest() == \
        "1a0ad88421393dca23432e28eb62b6915274206a01cd693289e97434007ac98b"
