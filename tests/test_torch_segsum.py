"""The fixed-order segment sum (`icpx_torch.utils.segsum`) and the sites
that sum through it.

Held bit for bit: `segment_sum` against an explicit Python loop that adds
each destination's contributions from zero in ascending contribution
order (duplicate (i, j) edges, an empty destination, a hub of degree 50,
the dense pose graph's 4-block layout), and past `RUN` contributions a
destination against the same loop run by run. Against a float64 sum:
within 1e-6 of the sum of magnitudes. The port keeps no floating-point
accumulating scatter outside `registration/step.py`'s 0/1 counts. The
solvers and `place_descriptor` are held to the JAX package in
`tests/test_torch_posegraph.py` and `tests/test_torch_slam.py`.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from icpx_torch.utils.segsum import RUN, segment_plan, segment_sum

torch.set_num_threads(2)


def _values(rng, e, shape=()):
    """Contributions whose magnitudes span six decades, so that the order
    of adds shows in the bits."""
    mag = np.exp(rng.uniform(-7.0, 7.0, (e,) + shape))
    return torch.as_tensor((rng.choice([-1.0, 1.0], (e,) + shape) * mag).astype(np.float32))


def _loop_sum(values, index, n):
    """Each destination's contributions added from zero in ascending order."""
    out = [torch.zeros(values.shape[1:], dtype=values.dtype) for _ in range(n)]
    for e, d in enumerate(index.tolist()):
        out[d] = out[d] + values[e]
    return torch.stack(out)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _edges(rng, m, extra):
    """A chain over m nodes plus `extra` (i, j) edges: (ei, ej) int64."""
    ei = list(range(m - 1)) + [i for i, _ in extra]
    ej = list(range(1, m)) + [j for _, j in extra]
    return torch.tensor(ei), torch.tensor(ej)


def _fixture(name, rng):
    """(index, n, values) of one fixture."""
    if name == "duplicate edges":
        ei, ej = _edges(rng, 8, [(2, 3), (2, 3), (5, 1), (1, 5), (0, 7), (0, 7), (0, 7)])
        index, n = torch.cat([ei, ej]), 8
    elif name == "empty destination":
        ei, ej = _edges(rng, 6, [(0, 5)])
        index, n = torch.cat([ei, ej]) + (torch.cat([ei, ej]) >= 3).long(), 10  # 3, 8, 9 empty
    elif name == "hub of degree 50":
        ei = torch.zeros(50, dtype=torch.int64)
        ej = torch.as_tensor(rng.integers(1, 20, 50))
        index, n = torch.cat([ei, ej]), 20
    else:  # the dense pose graph's (i, j) blocks: all ii, then ij, ji, jj
        m = 9
        ei, ej = _edges(rng, m, [(0, k) for k in range(2, m)] + [(4, 5), (4, 5), (6, 2)])
        keys, index = torch.unique(torch.cat([ei * m + ei, ei * m + ej, ej * m + ei, ej * m + ej]),
                                   return_inverse=True)
        n = keys.shape[0]
        return index, n, _values(rng, index.shape[0], (6, 6))
    return index, n, _values(rng, index.shape[0], (6,))


FIXTURES = ("duplicate edges", "empty destination", "hub of degree 50", "4-block dense layout")


@pytest.mark.parametrize("name", FIXTURES)
def test_segment_sum_adds_in_ascending_order(name):
    index, n, values = _fixture(name, np.random.default_rng(FIXTURES.index(name)))
    plan = segment_plan(index, n)
    got = segment_sum(values, plan)
    want = _loop_sum(values, index, n)
    assert got.shape == want.shape == (n,) + tuple(values.shape[1:])
    assert torch.equal(_bits(got), _bits(want))
    if name == "empty destination":
        assert torch.equal(_bits(got[[3, 8, 9]]), _bits(torch.zeros_like(got[[3, 8, 9]])))
    if name == "hub of degree 50":
        # the fixture is one whose bits depend on the order of adds
        backwards = _loop_sum(values.flip(0), index.flip(0), n)
        assert not torch.equal(_bits(got), _bits(backwards))


def test_segment_sum_past_a_run_sums_runs_in_order():
    """A destination of 300 contributions (and one of 64, one of 65): each
    run of RUN in order from zero, then the runs' sums the same way."""
    rng = np.random.default_rng(7)
    index = torch.cat([torch.full((300,), 1), torch.full((RUN,), 0), torch.full((RUN + 1,), 2)])
    index = index[torch.as_tensor(rng.permutation(index.shape[0]))]
    values = _values(rng, index.shape[0], (3,))
    got = segment_sum(values, segment_plan(index, 4))
    want = torch.zeros((4, 3))
    for d in range(4):
        rows = values[index == d]
        runs = [_loop_sum(rows[k:k + RUN], torch.zeros(len(rows[k:k + RUN]), dtype=torch.int64), 1)[0]
                for k in range(0, len(rows), RUN)]
        want[d] = _loop_sum(torch.stack(runs), torch.zeros(len(runs), dtype=torch.int64), 1)[0] \
            if runs else 0.0
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(got[3]), _bits(torch.zeros(3)))


@pytest.mark.parametrize("name", FIXTURES)
def test_segment_sum_against_float64(name):
    index, n, values = _fixture(name, np.random.default_rng(10 + FIXTURES.index(name)))
    got = segment_sum(values, segment_plan(index, n)).double()
    want = torch.zeros((n,) + tuple(values.shape[1:]), dtype=torch.float64)
    scale = torch.zeros_like(want)
    want.index_add_(0, index, values.double())
    scale.index_add_(0, index, values.double().abs())
    assert bool(((got - want).abs() <= 1e-6 * scale).all())


def test_segment_sum_of_nothing_and_a_wrong_length():
    plan = segment_plan(torch.zeros(0, dtype=torch.int64), 5)
    got = segment_sum(torch.zeros((0, 6)), plan)
    assert got.shape == (5, 6) and not bool(got.any())
    with pytest.raises(ValueError):
        segment_sum(torch.zeros((3, 6)), segment_plan(torch.tensor([0, 1]), 2))


def test_no_floating_point_accumulating_scatter_in_the_port():
    """Accumulating scatters add with atomics on CUDA, in no fixed order:
    every sum the reference makes with `.at[].add` goes through
    `segment_sum`. The one left, `registration/step.py`'s histogram, adds
    0/1 counts, exact in any order."""
    root = pathlib.Path(__file__).resolve().parents[1] / "icpx_torch"
    pat = re.compile(r"\.(index_add_?|scatter_add_?)\(|accumulate\s*=\s*True\)|bincount\([^)]*weights")
    hits = [f"{p.relative_to(root)}:{k + 1}" for p in sorted(root.rglob("*.py"))
            for k, line in enumerate(p.read_text().splitlines()) if pat.search(line)]
    assert hits == ["registration/step.py:127"], hits
