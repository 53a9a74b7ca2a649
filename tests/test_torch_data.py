"""The port's data pipeline (``repro_torch.data``) against the reference's
(``repro.data``, numpy only, so it runs in process): every batch, shard
and iterator yield must be bit-identical (``np.array_equal`` on int64
tokens), including vocabularies above 4096, where both read the bigram
table's 4096 rows through ``cur % 4096``."""
import itertools

import numpy as np
import pytest

from repro_torch.data import DataConfig, SyntheticLM, make_batch_iterator

# (vocab_size, seq_len, global_batch, extra DataConfig fields)
CASES = {
    "v1024-s32-b8-seed3": (1024, 32, 8, {"seed": 3}),
    "v512-s16-b4": (512, 16, 4, {}),
    "qwen2-vocab-s128-b4": (151936, 128, 4, {"seed": 0}),
    "zipf1.5-v2048-s64-b4": (2048, 64, 4, {"seed": 7, "zipf_a": 1.5}),
}


def _pair(case):
    from repro.data import DataConfig as RefConfig
    from repro.data import SyntheticLM as RefLM
    v, s, b, over = CASES[case]
    return (SyntheticLM(DataConfig(v, s, b, **over)),
            RefLM(RefConfig(v, s, b, **over)))


def _shard_cases():
    return [(case, dp) for case, (_, _, b, _) in CASES.items()
            for dp in (1, 2, 4, 8) if b % dp == 0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_global_batch_equals_the_reference(case):
    port, ref = _pair(case)
    assert np.array_equal(port._succ, ref._succ)
    for step in (0, 1, 11):
        got, want = port.global_batch_at(step), ref.global_batch_at(step)
        assert got.dtype == want.dtype == np.int64
        assert got.shape == want.shape
        assert np.array_equal(got, want)


@pytest.mark.parametrize("case,dp", _shard_cases())
def test_shards_equal_the_reference_and_tile_the_global_batch(case, dp):
    port, ref = _pair(case)
    for step in (0, 5):
        parts = [port.shard_at(step, r, dp) for r in range(dp)]
        for r, part in enumerate(parts):
            assert np.array_equal(part, ref.shard_at(step, r, dp))
        assert np.array_equal(np.concatenate(parts),
                              port.global_batch_at(step))


@pytest.mark.parametrize("case,dp_rank,dp_size",
                         [("v1024-s32-b8-seed3", 1, 2),
                          ("v512-s16-b4", 0, 1),
                          ("qwen2-vocab-s128-b4", 3, 4)])
def test_batch_iterator_from_step_5_equals_the_reference(case, dp_rank,
                                                          dp_size):
    from repro.data import DataConfig as RefConfig
    from repro.data import make_batch_iterator as ref_iterator
    v, s, b, over = CASES[case]
    got = list(itertools.islice(make_batch_iterator(
        DataConfig(v, s, b, **over), dp_rank, dp_size, start_step=5), 3))
    want = list(itertools.islice(ref_iterator(
        RefConfig(v, s, b, **over), dp_rank, dp_size, start_step=5), 3))
    assert [sorted(g) for g in got] == [["tokens"]] * 3
    for g, w in zip(got, want):
        assert np.array_equal(g["tokens"], w["tokens"])


def test_vocab_above_4096_reads_4096_table_rows():
    ds = SyntheticLM(DataConfig(vocab_size=151936, seq_len=64,
                                global_batch=2, seed=0))
    assert ds._succ.shape == (4096, 8)
    tokens = ds.global_batch_at(0)
    assert tokens.min() >= 0 and tokens.max() < 151936


# the reference's own tests (tests/test_checkpoint_data.py), on the port

def test_data_elastic_repartition_identical():
    cfg = DataConfig(vocab_size=1024, seq_len=32, global_batch=8, seed=3)
    ds = SyntheticLM(cfg)
    full = ds.global_batch_at(step=11)
    for dp in (1, 2, 4, 8):
        parts = np.concatenate([ds.shard_at(11, r, dp) for r in range(dp)])
        np.testing.assert_array_equal(parts, full)


def test_data_restart_replays():
    cfg = DataConfig(vocab_size=512, seq_len=16, global_batch=4)
    ds1, ds2 = SyntheticLM(cfg), SyntheticLM(cfg)
    np.testing.assert_array_equal(ds1.shard_at(5, 0, 2), ds2.shard_at(5, 0, 2))


@pytest.mark.parametrize("a", [1.2, 1.5, 1.01, 3.0])
def test_zipf_draws_are_numpy_2_0s(a):
    """The port's Zipf draw equals ``Generator.zipf`` of the numpy the
    reference is tested with (2.0), draw for draw, rejections and the
    uniforms after them included."""
    from repro_torch.data.pipeline import _zipf
    mine, ref = np.random.default_rng(5), np.random.default_rng(5)
    assert [_zipf(mine, a) for _ in range(20000)] == \
        [int(ref.zipf(a)) for _ in range(20000)]
    assert mine.random() == ref.random()


def test_zipf_draws_are_the_same_under_every_numpy():
    """A frozen run of the port's Zipf draws (numpy 2.0's), which numpy
    2.1's changed sampler no longer gives from these uniforms (its sixth
    draw is 778612, its ninth 326); and numpy's refusal of a <= 1."""
    from repro_torch.data.pipeline import _zipf
    rng = np.random.default_rng((0, 0, 0, 0x5DEECE66D))
    rng.integers(0, 4096, size=5)
    rng.random(3)
    assert [_zipf(rng, 1.2) for _ in range(10)] == \
        [2, 24, 41, 33, 15, 787500, 1, 2, 327, 82]
    with pytest.raises(ValueError, match="a <= 1"):
        _zipf(rng, 1.0)
