"""Rank layouts of the port's meshes, without processes.

The placement rule of tests/test_mesh_topology.py on ranks: the drivers'
default meshes keep every per-frame migration ring inside a node and let
one block-wise axis cross the node seam, and every layout that cannot be
honoured says so.  Nodes are contiguous blocks of ``LOCAL_WORLD_SIZE``
ranks, passed here as ``local_world_size``.
"""

import numpy as np
import pytest
import torch

from particlesystem_tpu_torch.parallel import mesh as meshmod

torch.set_num_threads(1)


def node_of(rank, per_node=4):
    return rank // per_node


def test_block_layout_keeps_ring_axes_intra_node():
    """Pencil (4, 2) over 2 nodes of 4: the "y" ring of every x index
    stays in one node; an "x" ring crosses the seam only at the block
    boundary and the wraparound."""
    arr = meshmod._block_rank_array(meshmod._node_granules(8, 2), (2, 2),
                                    (2, 1))
    assert arr.shape == (4, 2)
    for i in range(4):
        assert len({node_of(r) for r in arr[i, :]}) == 1
    col = [node_of(r) for r in arr[:, 0]]
    assert sum(col[i] != col[(i + 1) % 4] for i in range(4)) == 2


def test_brick_layout_keeps_both_ring_axes_intra_node():
    arr = meshmod.hybrid_layout((1, 2, 2), (2, 1, 1), local_world_size=4)
    assert arr.shape == (2, 2, 2)
    for a in range(2):
        assert len({node_of(r) for r in arr[a].ravel()}) == 1


@pytest.mark.parametrize("shape,ici,dcn", [
    ((4, 2), (2, 2), (2, 1)), ((2, 2, 2), (1, 2, 2), (2, 1, 1)),
    ((8,), (4,), (2,))])
def test_default_layout_is_the_hybrid_rule_on_nodes(shape, ici, dcn):
    """Two nodes of four ranks: the default layout is the node-block
    layout with the seam on axis 0 (node 0's ranks fill the first half of
    axis 0, node 1's the second)."""
    arr = meshmod.default_layout(shape, local_world_size=4)
    np.testing.assert_array_equal(
        arr, meshmod.hybrid_layout(ici, dcn, local_world_size=4))
    half = shape[0] // 2
    assert {node_of(r) for r in arr[:half].ravel()} == {0}
    assert {node_of(r) for r in arr[half:].ravel()} == {1}


def test_default_layout_flat_on_one_node():
    np.testing.assert_array_equal(meshmod.default_layout((8,)), np.arange(8))
    np.testing.assert_array_equal(
        meshmod.default_layout((2, 2, 2), local_world_size=8),
        np.arange(8).reshape(2, 2, 2))


def test_default_layout_warns_when_topology_cannot_be_honored():
    """Three nodes cannot tile axis 0 of a (4, 2) mesh: the fallback to
    flat order is loud, not silent."""
    with pytest.warns(RuntimeWarning, match="cannot be honored"):
        arr = meshmod.default_layout((4, 2), local_world_size=3)
    np.testing.assert_array_equal(arr, np.arange(8).reshape(4, 2))


def test_hybrid_layout_rejects_a_mismatched_node_split():
    with pytest.raises(ValueError, match="nodes"):
        meshmod.hybrid_layout((4,), (2,), local_world_size=2)
    with pytest.raises(ValueError, match="rank mismatch"):
        meshmod.hybrid_layout((4,), (2, 1))


@pytest.mark.parametrize("layout", ["flat", "hybrid"])
def test_rank_mesh_coordinates_and_peers(layout):
    """Every rank finds itself and its ring neighbours on the grid, and
    the rows it holds follow its position, not its rank."""
    ranks = (np.arange(8).reshape(4, 2) if layout == "flat"
             else meshmod.hybrid_layout((4, 1), (1, 2), local_world_size=4))
    for r in range(8):
        m = meshmod.RankMesh(ranks, ("x", "y"), rank=r)
        assert ranks[m.coords] == r
        assert m.shape == (4, 2) and m.size == 8
        a, b = m.coords
        assert m.peer("x", (a + 1) % 4) == ranks[(a + 1) % 4, b]
        assert m.peer("y", b) == r
        assert m.position(r) == a * 2 + b


def test_rank_mesh_checks():
    with pytest.raises(ValueError, match="permutation"):
        meshmod.RankMesh(np.array([0, 0]), ("x",), rank=0)
    with pytest.raises(ValueError, match="needs its group"):
        meshmod.RankMesh(np.arange(2), ("x",))
    lone = meshmod.mesh_1d(1)
    x = torch.arange(3.0)
    assert lone.psum(x) is x and lone.pmax(x) is x
    # a message that no one sends arrives as zeros (JAX's rule)
    out, = lone.exchange("x", [([x], [])])
    assert not out[0].any()
