"""The frozen generator draws what the port's generator draws, and the
benchmark's weights have the port's leaves."""
import json

import numpy as np
import pytest
import torch

from esdbench.feed import first_batches
from esdbench.gen import CTRStream, record_width
from esdbench.manifest import HERE
from esdbench.weights import BLOCK_ROWS, leaf_blocks, leaf_specs, make_leaf


def _cfg(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def _mix(name="esd.n8b128.d2"):
    return json.loads((HERE / "mixes" / f"{name}.json").read_text())


@pytest.mark.parametrize("hist_max", [0, 48])
def test_frozen_generator_draws_the_ports_stream(hist_max):
    """The S1 stream of the port, with Criteo's 26 ids a sample (no
    history bag) as the configuration has it, and with the port's own
    48-slot bag."""
    import dataclasses

    from repro_torch.data.synthetic import WORKLOADS
    cfg = dict(_cfg("wdl-s1"), hist_max=hist_max)
    mix = dict(_mix(), hist_mean=12.0)
    ours = CTRStream(cfg, mix).batches(2 ** 31 + 3, 256)
    ports = dataclasses.replace(WORKLOADS["S1"], hist_max=hist_max
                                ).stream(2 ** 31 + 3, 256)
    for _ in range(2):
        (a, b, c), (x, y, z) = next(ours), next(ports)
        assert a.shape == (256, 26 + hist_max)
        np.testing.assert_array_equal(a, x)
        assert a.dtype == np.int32
        np.testing.assert_array_equal(b, y)
        np.testing.assert_array_equal(c, z)


def test_every_seed_draws_its_own_ids():
    cfg, mix = _cfg("wdl-s1"), dict(_mix(), workers=2, batch_per_worker=64)
    a = first_batches(cfg, mix, 5, 2)
    b = first_batches(cfg, mix, 5, 2)
    c = first_batches(cfg, mix, 2 ** 33 + 6, 2)
    assert all((x[0] == y[0]).all() and (x[1] == y[1]).all()
               for x, y in zip(a, b))
    assert not (a[0][0] == c[0][0]).all()
    off = CTRStream(cfg, mix).offsets()
    sizes = CTRStream(cfg, mix).table_sizes
    for sa, _, _ in a + c:
        assert sa.shape == (128, 26) and (sa >= 0).all()
        # each column's ids stay in their table
        assert ((sa >= off) & (sa < off + np.asarray(sizes))).all()


@pytest.mark.parametrize("hist_max", [0, 5])
def test_multi_hot_records_lay_out_each_fields_bag(hist_max):
    """Field f's b_f ids fill its own columns, in its table, with no
    PAD; the history bag follows; every id of a sample keeps to the
    sample's user group as often as the mix says."""
    bags = [3, 1, 2, 1, 1, 4]
    cfg = dict(_cfg("wdl-s1"), table_sizes=[2000, 2000, 100, 100, 100, 100],
               bag_sizes=bags, hist_max=hist_max)
    mix = dict(_mix(), workers=4, batch_per_worker=64, hist_mean=2.0,
               large_table_rows=1000)
    assert record_width(cfg) == 12 + hist_max
    gen = CTRStream(cfg, mix)
    off, sizes = gen.offsets(), gen.table_sizes
    (ids, dense, labels), = first_batches(cfg, mix, 2 ** 32 + 9, 1)
    assert ids.shape == (256, 12 + hist_max) and dense.shape == (256, 13)
    col = 0
    for f, b in enumerate(bags):
        block = ids[:, col:col + b]
        assert ((block >= off[f]) & (block < off[f] + sizes[f])).all()
        col += b
    hist = ids[:, col:]
    assert ((hist == -1) | ((hist >= 0) & (hist < sizes[0]))).all()
    # a bag's ids are drawn apart: the 3-id bag of field 0 is not one
    # id repeated
    assert (ids[:, 0] != ids[:, 1]).any()
    # field 0's large table: two ids of one sample share their group's
    # slice when both draw from it (0.7 x 0.7; 0.54 here); ids of two
    # samples meet in one slice in 0.10 of pairs here
    slice_of = ids[:, 1:3] // (2000 // mix["n_groups"])
    assert (slice_of[:, 0] == slice_of[:, 1]).mean() > 0.4


def test_bag_sizes_must_match_the_tables():
    cfg = dict(_cfg("wdl-s1"), bag_sizes=[1] * 25)
    with pytest.raises(ValueError):
        CTRStream(cfg, _mix())
    with pytest.raises(ValueError):
        CTRStream(dict(cfg, bag_sizes=[0] + [1] * 25), _mix())


@pytest.mark.parametrize("kind", ["wdl", "dcn"])
def test_leaves_are_the_ports(kind):
    from repro_torch.configs import DLRM_CONFIGS
    from repro_torch.data.synthetic import WORKLOADS
    from repro_torch.models.dlrm import init_params
    pcfg = DLRM_CONFIGS[f"{kind}-tiny"]
    wl = WORKLOADS["tiny"]
    model = init_params(pcfg, wl, torch.Generator().manual_seed(0), "cpu")
    cfg = dict(_cfg("wdl-s1"), kind=kind,
               embedding_dim=16, mlp_dims=[64, 32], cross_layers=2,
               table_sizes=list(wl.table_sizes))
    ours = {name: shape for name, shape, _ in leaf_specs(cfg)}
    theirs = {name: tuple(p.shape) for name, p in model.named_parameters()}
    assert ours == theirs


def test_the_programs_model_is_built_from_the_configuration():
    """The port's config from the keys that name its fields (a field
    added later is read from the file), the leaves grouped as the
    model's keywords, lists in index order."""
    import dataclasses

    from esdbench.program import leaf_groups, model_config
    from repro_torch.configs.dlrm_configs import DLRMConfig
    cfg = _cfg("wdl-s1")
    assert model_config(DLRMConfig, cfg) == DLRMConfig(
        "wdl-s1", "wdl", "S1", embedding_dim=512, n_dense=13,
        mlp_dims=(1024, 512, 256), cross_layers=0)

    @dataclasses.dataclass(frozen=True)
    class Later(DLRMConfig):
        bag_sizes: tuple = ()
    got = model_config(Later, dict(cfg, bag_sizes=[3, 1]))
    assert got.bag_sizes == (3, 1) and got.workload == "S1"
    w = {"top.1": 1, "embed": 0, "top.0": 2, "bottom.0": 3, "cross_w": 4}
    assert leaf_groups(w) == {"embed": 0, "cross_w": 4, "top": [2, 1],
                              "bottom": [3]}


def test_a_leaf_is_its_blocks_and_repeats():
    spec = ("embed", (BLOCK_ROWS + 7, 4), 0.01)
    a = make_leaf(2 ** 32 + 1, 0, spec, "cpu")
    b = torch.cat([blk for _, blk in leaf_blocks(2 ** 32 + 1, 0, spec,
                                                 "cpu")])
    assert torch.equal(a, b)
    assert torch.equal(a, make_leaf(2 ** 32 + 1, 0, spec, "cpu"))
    assert not torch.equal(a, make_leaf(2 ** 32 + 2, 0, spec, "cpu"))
    assert 0.009 < float(a.std()) < 0.011
