"""Multi-device sharding tests on the 8-device virtual CPU mesh (conftest sets
--xla_force_host_platform_device_count=8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spmv_acc_tpu.formats import powerlaw_csr, random_csr
from spmv_acc_tpu.formats.generate import random_x_y
from spmv_acc_tpu.ops.golden import host_spmv_plain
from spmv_acc_tpu.parallel import (
    balance_row_cuts,
    dist_spmv,
    make_mesh,
    partition_rows,
    shard_partitioned,
    unpad_y,
)
from spmv_acc_tpu.parallel.dist_spmv import dist_spmv_fn
from spmv_acc_tpu.utils.verify import verify_y


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_balance_row_cuts():
    csr = powerlaw_csr(100, 100, avg_nnz=5, seed=41)
    rp = np.asarray(csr.row_ptr)
    cuts = balance_row_cuts(rp, 4)
    assert cuts[0] == 0 and cuts[-1] == 100
    shard_nnz = rp[cuts[1:]] - rp[cuts[:-1]]
    # balanced to within one max row length
    lens = np.diff(rp)
    assert shard_nnz.max() - shard_nnz.min() <= 2 * lens.max() + csr.nnz // 4


@pytest.mark.parametrize("num_shards", [2, 4, 8])
@pytest.mark.parametrize("gen", ["random", "powerlaw"])
def test_dist_spmv_matches_golden(num_shards, gen):
    csr = (
        random_csr(96, 96, 900, seed=42)
        if gen == "random"
        else powerlaw_csr(96, 96, avg_nnz=7, seed=43)
    )
    m, n = csr.shape
    x, _ = random_x_y(n, m, seed=44)
    golden = host_spmv_plain(*csr.to_numpy()[:3], x)

    part = partition_rows(csr, num_shards)
    mesh = make_mesh(num_shards)
    part = shard_partitioned(part, mesh)
    y_pad = dist_spmv(part, jnp.asarray(x), mesh=mesh)
    y = unpad_y(part, y_pad)
    assert verify_y(np.asarray(y), golden).ok


def test_dist_spmv_sharding_layout():
    """The compiled distributed SpMV must actually shard over the mesh axis."""
    csr = random_csr(64, 64, 400, seed=45)
    part = partition_rows(csr, 8)
    mesh = make_mesh(8)
    part = shard_partitioned(part, mesh)
    run, x_pad = dist_spmv_fn(mesh, part)
    x = jnp.zeros((8 * x_pad,))
    from jax.sharding import NamedSharding, PartitionSpec as P

    x = jax.device_put(x, NamedSharding(mesh, P("x")))
    y = run(part.values, part.col_idx, part.row_ids, x)
    assert len(y.sharding.device_set) == 8


def test_dist_cg_solve():
    """Distributed CG on the 8-device mesh solves an SPD system."""
    from spmv_acc_tpu.formats.convert import coo_to_csr_arrays, csr_to_dense
    from spmv_acc_tpu.formats.containers import CSR
    from spmv_acc_tpu.formats import banded_csr
    from spmv_acc_tpu.models.cg import dist_cg_solve
    from spmv_acc_tpu.parallel import pad_vector, unpad_vector

    m = 64
    base = banded_csr(m, bandwidth=3, seed=46)
    d = csr_to_dense(*base.to_numpy())
    d = 0.5 * (d + d.T) + np.eye(m) * (np.abs(d).sum(axis=1) + 1.0)
    rr, cc = np.nonzero(d)
    rp, ci, v = coo_to_csr_arrays(rr, cc, d[rr, cc], (m, m))
    csr = CSR.from_numpy(rp, ci, v, (m, m))

    rng = np.random.default_rng(47)
    x_true = rng.random(m)
    b = d @ x_true

    mesh = make_mesh(4)
    part = partition_rows(csr, 4, balance=False)
    part = shard_partitioned(part, mesh)
    bp = pad_vector(part, b)
    res = dist_cg_solve(part, bp, mesh, tol=1e-12, max_iters=200)
    x = np.asarray(unpad_vector(part, jax.device_get(res.x)))
    assert np.allclose(x, x_true, atol=1e-8), np.abs(x - x_true).max()


@pytest.mark.parametrize("num_shards", [2, 4, 8])
def test_dist_spmv_halo_matches_golden(num_shards):
    """1-hop halo exchange (ppermute of neighbor x blocks) vs the CPU golden on
    a banded matrix, where every shard's column span fits the 3-block window."""
    from spmv_acc_tpu.formats.generate import banded_csr
    from spmv_acc_tpu.parallel.dist_spmv import halo_feasible

    csr = banded_csr(4000, bandwidth=9, seed=13, dtype=np.float64)
    part = partition_rows(csr, num_shards, balance=False)
    assert halo_feasible(part), "banded partition must admit the halo exchange"
    mesh = make_mesh(num_shards)
    part = shard_partitioned(part, mesh)
    x, _ = random_x_y(csr.shape[1], csr.shape[0], seed=5, dtype=np.float64)
    y = np.asarray(unpad_y(part, dist_spmv(part, jnp.asarray(x), mesh, halo=True)))
    golden = host_spmv_plain(*csr.to_numpy()[:3], x)
    rep = verify_y(y, golden, dtype=np.float64)
    assert rep.failed_count == 0, rep


def test_dist_spmv_halo_infeasible_falls_back():
    """A matrix with global scatter exceeds the 3-block window; auto mode must
    fall back to all-gather and still match the golden."""
    from spmv_acc_tpu.parallel.dist_spmv import halo_feasible

    csr = random_csr(600, 600, 6000, seed=3)
    part = partition_rows(csr, 8, balance=False)
    assert not halo_feasible(part)
    mesh = make_mesh(8)
    part = shard_partitioned(part, mesh)
    x, _ = random_x_y(csr.shape[1], csr.shape[0], seed=6, dtype=np.float64)
    y = np.asarray(unpad_y(part, dist_spmv(part, jnp.asarray(x), mesh)))
    golden = host_spmv_plain(*csr.to_numpy()[:3], x)
    rep = verify_y(y, golden, dtype=np.float64)
    assert rep.failed_count == 0, rep


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (8, 1), (1, 8)])
def test_hybrid_mesh_spmv_matches_golden(shape):
    """Hybrid DCN x ICI mesh: the two-stage all-gather (ici then dcn) must
    reproduce the flat gather's result for every grid factoring."""
    from spmv_acc_tpu.parallel.multihost import (dist_spmv_hier, hybrid_mesh,
                                                 shard_partitioned_hier)

    csr = powerlaw_csr(96, 96, avg_nnz=7, seed=51)
    m, n = csr.shape
    x, _ = random_x_y(n, m, seed=52)
    golden = host_spmv_plain(*csr.to_numpy()[:3], x)
    dcn, ici = shape
    mesh = hybrid_mesh(dcn=dcn, ici=ici)
    part = partition_rows(csr, dcn * ici)
    part = shard_partitioned_hier(part, mesh)
    y = unpad_y(part, dist_spmv_hier(part, jnp.asarray(x), mesh=mesh))
    assert verify_y(np.asarray(y), golden).ok


def test_init_distributed_single_process():
    """Without a coordinator or cluster env the bootstrap is a no-op returning
    the single-process context."""
    from spmv_acc_tpu.parallel.multihost import init_distributed

    ctx = init_distributed()
    assert not ctx.initialized
    assert ctx.process_count == 1 and ctx.process_index == 0
    assert ctx.global_device_count == 8  # the virtual CPU mesh
