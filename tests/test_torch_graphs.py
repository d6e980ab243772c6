"""Port host layer vs the JAX package: generators, hashing, bucket grid.

Everything here is integer or exact float data, so every comparison is
exact equality."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import utils as ref_utils
from repro.graphs import generators as ref_gen
from repro_torch import utils as pt_utils
from repro_torch.graphs import generators as pt_gen

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core oversubscribes the machine
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

GENERATORS = {
    "clique8": lambda gen: gen.clique(8),
    "karate": lambda gen: gen.karate(),
    "rmat7": lambda gen: gen.rmat(7, 8, seed=1),
    "rmat9": lambda gen: gen.rmat(9, 16, seed=0),
    "er": lambda gen: gen.erdos_renyi(150, 900, seed=2),
    "social": lambda gen: gen.temporal_social(120, 1200, seed=4),
}


def assert_graphs_equal(a, b):
    assert a.n == b.n
    assert a.spec.__dict__ == b.spec.__dict__
    for f in ("src", "dst", "vmeta_i", "vmeta_f", "emeta_i", "emeta_f"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (a.sample_p, a.sample_seed) == (b.sample_p, b.sample_seed)


@pytest.mark.parametrize("name", list(GENERATORS))
def test_generator_arrays_equal_reference(name):
    ref = GENERATORS[name](ref_gen)
    port = GENERATORS[name](pt_gen)
    assert_graphs_equal(ref, port)
    assert_graphs_equal(ref.with_degree_meta(), port.with_degree_meta())
    np.testing.assert_array_equal(ref.degrees(), port.degrees())
    np.testing.assert_array_equal(ref.vertex_hashes(), port.vertex_hashes())


def test_smoke_script_karate_edges_equal_networkx():
    """chip_smoke.py carries karate's edges (the card's machine has no
    networkx); they must build the generator's graph exactly."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    e = np.array(chip_smoke.KARATE_EDGES, np.int64)
    g = pt_gen.HostGraph.from_edges(34, e[:, 0], e[:, 1])
    assert_graphs_equal(g, pt_gen.karate())


def _sweep():
    rng = np.random.default_rng(0)
    edge = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x80000001,
                     0xFFFFFFFE, 0xFFFFFFFF], np.uint32)
    return np.concatenate([edge, rng.integers(0, 2**32, 100_000,
                                              dtype=np.uint64).astype(np.uint32)])


def test_splitmix32_torch_equals_numpy_reference():
    x = _sweep()
    want = ref_utils.splitmix32_np(x)
    np.testing.assert_array_equal(pt_utils.splitmix32_np(x), want)
    got = pt_utils.splitmix32(torch.as_tensor(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    # the int32-bits storage round trip keeps every bit
    bits = pt_utils.u32_bits(got)
    assert bits.dtype == torch.int32
    np.testing.assert_array_equal(bits.numpy().view(np.uint32), want)


def test_u32_key_orders_unsigned():
    x = np.sort(_sweep()[:2000])
    k = pt_utils.u32_key(torch.as_tensor(x.view(np.int32)))
    assert bool((k[1:] >= k[:-1]).all())
    assert torch.equal(pt_utils.u32_key(k), torch.as_tensor(x.view(np.int32)))


@pytest.mark.parametrize("fn", ["bucket_cap", "bucket_floor"])
def test_bucket_grid_equals_reference(fn):
    xs = list(range(0, 5000)) + [2**k + d for k in range(12, 31)
                                 for d in (-1, 0, 1, 12345)]
    ref, port = getattr(ref_utils, fn), getattr(pt_utils, fn)
    assert [port(x) for x in xs] == [ref(x) for x in xs]
    a = np.arange(0, 3000).reshape(30, 100)
    np.testing.assert_array_equal(pt_utils.bucket_caps(a), ref_utils.bucket_caps(a))


def test_small_helpers_equal_reference():
    x = np.arange(5, dtype=np.int32)
    np.testing.assert_array_equal(pt_utils.pad_to(x, 9, 7), ref_utils.pad_to(x, 9, 7))
    m = np.ones((2, 3), np.int32)
    np.testing.assert_array_equal(pt_utils.pad_axis_to(m, 1, 5, 4),
                                  ref_utils.pad_axis_to(m, 1, 5, 4))
    assert [pt_utils.ceil_div(a, 4) for a in range(10)] == \
        [ref_utils.ceil_div(a, 4) for a in range(10)]
    rng = np.random.default_rng(1)
    cols = [rng.integers(0, 3, 50) for _ in range(6)]
    np.testing.assert_array_equal(pt_utils.key_less(*cols),
                                  np.asarray(ref_utils.key_less(*cols)))


def test_default_device_is_the_card():
    """``device=None`` means CUDA; without a card it raises instead of
    falling back to the CPU."""
    if torch.cuda.is_available():
        assert pt_utils.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt_utils.resolve_device(None)
    assert pt_utils.resolve_device("cpu").type == "cpu"
