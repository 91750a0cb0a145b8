"""What the existing cells read stays what it was before each model
kind's leaves and operations moved into its own module and records
grew per-field bags: the leaves, the operations a sample, the record's
width and the first batches of the stream, each pinned to the values
the harness gave before that change."""
import hashlib

import pytest

from esdbench import peaks, weights
from esdbench._tiny import CELL, write_tiny
from esdbench.gen import first_batches, record_width
from esdbench.manifest import HERE, Bench

SEED = 2 ** 31 + 17
MLP = [("bottom.0", (13, 1024), 0.2773500981126146),
       ("bottom.1", (1024, 512), 0.03125),
       ("bottom.2", (512, 256), 0.04419417382415922),
       ("bottom.3", (256, 512), 0.0625),
       ("top.0", (512, 1024), 0.04419417382415922),
       ("top.1", (1024, 512), 0.03125),
       ("top.2", (512, 256), 0.04419417382415922),
       ("top.3", (256, 1), 0.0625)]
WDL_S1 = ([("embed", (502000, 512), 0.01)] + MLP
          + [("wide", (502000, 1), 0.01)], 11919438.0, 26,
          "7e17ce13f73168361069976f5133bbc7b67822dc8dd7ab9e3d35a7ea999a3dab")
TINY = ([("embed", (4400, 16), 0.01),
         ("bottom.0", (13, 64), 0.2773500981126146),
         ("bottom.1", (64, 32), 0.125),
         ("bottom.2", (32, 16), 0.1767766952966369),
         ("top.0", (16, 64), 0.25),
         ("top.1", (64, 32), 0.125),
         ("top.2", (32, 1), 0.1767766952966369),
         ("wide", (4400, 1), 0.01)], 39330.0, 6,
        "5ae2624faf13687f837c50e8296688b2f3a1ccf5c6eb86718d50ee60f5bc9461")
PINNED = {"wdl-s1.esd.n8b128.d2": WDL_S1, "wdl-s1.esd.n8b128.d1": WDL_S1,
          "wdl-s1.esd.n8b128.d2.int8": WDL_S1, CELL: TINY}


def _sha(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(a.tobytes())
    return h.hexdigest()


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """Each cell's configuration and mix: the benchmark's and the tiny
    cell's."""
    out = {}
    root = write_tiny(tmp_path_factory.mktemp("tiny"))
    for bench in (Bench(HERE.parent), Bench(root, root)):
        for cell in bench.data["workloads"]:
            out[cell["name"]] = (bench.config(cell["config"]),
                                 bench.mix(cell["traffic"]))
    return out


def test_every_cell_is_pinned(cells):
    assert set(cells) == set(PINNED)


@pytest.mark.parametrize("cell", sorted(PINNED))
def test_cell_reads_as_before(cells, cell):
    cfg, mix = cells[cell]
    specs, flops, width, stream = PINNED[cell]
    assert weights.leaf_specs(cfg) == specs
    assert peaks.model_flops_per_sample(cfg) == flops
    assert record_width(cfg) == width
    assert _sha(a for batch in first_batches(cfg, mix, SEED, 3)
                for a in batch) == stream


def test_tiny_weights_are_as_before(cells):
    cfg, _ = cells[CELL]
    w = weights.make_weights(cfg, SEED, "cpu")
    h = hashlib.sha256()
    for name, leaf in w.items():
        h.update(name.encode())
        h.update(leaf.numpy().tobytes())
    assert h.hexdigest() == \
        "1a0ad88421393dca23432e28eb62b6915274206a01cd693289e97434007ac98b"

