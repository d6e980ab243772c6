"""The port's neighbour sampler vs the JAX package's, bit for bit.

``CSRHost.from_graph`` (a stable sort by source in the port, a loop over
every edge in the reference) gives the same ``indptr`` and ``indices``;
``sample_subgraph`` from generators in the same state draws the same
subgraph and leaves the generators in the same state. On
``rmat(8, 8, seed=3)`` as tests/test_train.py samples it, and on graphs
with isolated vertices and a hub."""
import numpy as np
import pytest

from repro.graphs import generators as rgen
from repro.graphs.csr import HostGraph as RefHostGraph
from repro.graphs.sampler import CSRHost as RefCSRHost
from repro.graphs.sampler import sample_subgraph as ref_sample
from repro_torch.graphs import generators as pgen
from repro_torch.graphs.csr import HostGraph
from repro_torch.graphs.sampler import CSRHost, sample_subgraph


def graphs():
    """(reference HostGraph, port HostGraph) pairs."""
    out = [(rgen.rmat(8, 8, seed=3), pgen.rmat(8, 8, seed=3))]
    # a star with isolated vertices: vertex 0 linked to 1..40, 41..59 alone
    src, dst = np.zeros(40, np.int64), np.arange(1, 41)
    out.append((RefHostGraph.from_edges(60, src, dst),
                HostGraph.from_edges(60, src, dst)))
    return out


def equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and np.array_equal(x, y), k


@pytest.mark.parametrize("which", [0, 1])
def test_csr_host_bit_for_bit(which):
    ref_g, port_g = graphs()[which]
    assert np.array_equal(ref_g.src, port_g.src)
    a, b = RefCSRHost.from_graph(ref_g), CSRHost.from_graph(port_g)
    equal(vars(a), vars(b))


@pytest.mark.parametrize("fanouts", [(5, 3), (15, 10), (2,), (1, 1, 1)])
def test_sample_subgraph_bit_for_bit(fanouts):
    for ref_g, port_g in graphs():
        a, b = RefCSRHost.from_graph(ref_g), CSRHost.from_graph(port_g)
        rng_a, rng_b = np.random.default_rng(0), np.random.default_rng(0)
        for _ in range(3):
            seeds = rng_a.choice(ref_g.n, 16, replace=False)
            assert np.array_equal(seeds, rng_b.choice(port_g.n, 16,
                                                      replace=False))
            equal(ref_sample(a, seeds, fanouts, rng_a),
                  sample_subgraph(b, seeds, fanouts, rng_b))
        assert rng_a.bit_generator.state == rng_b.bit_generator.state


def test_sampler_shapes_and_locality():
    """tests/test_train.py's check on the port: static shapes, every
    sampled edge a real edge, the seeds first."""
    g = pgen.rmat(8, 8, seed=3)
    csr = CSRHost.from_graph(g)
    rng = np.random.default_rng(0)
    seeds = rng.choice(g.n, 16, replace=False)
    sub = sample_subgraph(csr, seeds, (5, 3), rng)
    assert sub["nodes"].shape == (16 + 80 + 240,)
    assert sub["edge_src"].shape == sub["edge_dst"].shape == (320,)
    es = set(map(tuple, np.stack([g.src, g.dst], 1).tolist()))
    es |= {(b, a) for a, b in es}
    for i in range(sub["n_edges"]):
        u = sub["nodes"][sub["edge_src"][i]]
        v = sub["nodes"][sub["edge_dst"][i]]
        assert (int(u), int(v)) in es
    assert not sub["edge_valid"][sub["n_edges"]:].any()
    np.testing.assert_array_equal(sub["nodes"][:16], seeds)
