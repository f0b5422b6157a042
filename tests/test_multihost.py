"""Multi-host bootstrap (VERDICT round-4 missing #1 / next-round item 3).

The reference reserves multi-rank nodes (job_submit_d2q9-bgk:5); here the
answer is one JAX process per host with jax.distributed forming the
process group.  No second host exists here, so these tests cover the
pure detection ladder with mocked environments, the idempotent no-op on
single-process environments, and the single-process behavior of the
multi-host-safe put/fetch helpers (which the existing sharded tests
exercise end-to-end on the virtual mesh).
"""

import numpy as np

from advanced_hpc_lbm_tpu.parallel import multihost


class TestDetect:
    def test_empty_env_is_single_process(self):
        assert multihost.detect({}) is None

    def test_explicit_coordinator(self):
        kw = multihost.detect({
            "JAX_COORDINATOR_ADDRESS": "10.0.0.1:1234",
            "JAX_NUM_PROCESSES": "4",
            "JAX_PROCESS_ID": "2",
        })
        assert kw == {
            "coordinator_address": "10.0.0.1:1234",
            "num_processes": 4,
            "process_id": 2,
        }

    def test_explicit_coordinator_with_slurm_rank_fallback(self):
        kw = multihost.detect({
            "JAX_COORDINATOR_ADDRESS": "head:99",
            "SLURM_NTASKS": "8",
            "SLURM_PROCID": "5",
        })
        assert kw["num_processes"] == 8 and kw["process_id"] == 5

    def test_slurm_multitask(self):
        kw = multihost.detect({
            "SLURM_NTASKS": "4",
            "SLURM_PROCID": "3",
            "SLURM_STEP_NODELIST": "gpu-node[07-10]",
        })
        assert kw["coordinator_address"].startswith("gpu-node07:")
        assert kw["num_processes"] == 4 and kw["process_id"] == 3

    def test_slurm_single_task_is_single_process(self):
        # the repo's own job script reserves --ntasks-per-node 1
        assert multihost.detect({"SLURM_NTASKS": "1"}) is None


class TestNodelist:
    def test_bracket_range(self):
        assert multihost._first_slurm_host("n[3-7,9]") == "n3"

    def test_bracket_list(self):
        assert multihost._first_slurm_host("gpu[12,15]") == "gpu12"

    def test_plain_list(self):
        assert multihost._first_slurm_host("alpha,beta") == "alpha"

    def test_single(self):
        assert multihost._first_slurm_host("solo") == "solo"


def test_maybe_initialize_noop_single_process():
    """With a single-process environment nothing is initialized and jax
    is never imported by the call (the no-op must stay cheap — it runs
    first thing in every CLI invocation)."""
    assert multihost.maybe_initialize({}) is False
    assert multihost._initialized is False


def test_is_primary_single_process():
    assert multihost.is_primary() is True
    assert multihost.process_count() == 1


def test_put_single_process_matches_device_put():
    """halo._put must be a plain device_put when process_count == 1 —
    the multi-host callback assembly path must not engage."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from advanced_hpc_lbm_tpu.parallel import halo
    from advanced_hpc_lbm_tpu.parallel.mesh import make_y_mesh

    mesh = make_y_mesh(4)
    sh = NamedSharding(mesh, P("y"))
    x = np.arange(32, dtype=np.float32)
    a = halo._put(x, sh)
    b = jax.device_put(x, sh)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert a.sharding == b.sharding


def test_to_host_fully_addressable_passthrough():
    import jax.numpy as jnp

    from advanced_hpc_lbm_tpu.models.d2q9_bgk import _to_host

    x = jnp.arange(6.0)
    out = _to_host(x)
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, np.arange(6.0))
