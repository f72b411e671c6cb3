"""The cases of ``tests/test_stash_replication_fault.py`` on the port:
weight stashing (``core/stash``), the replication policy and stores
(``core/replication``, ``checkpoint/replication_store``) and the §III-F
fault state machine (``core/fault``), with tensors where the reference
has jax arrays; the planners' outputs are held equal to the reference's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import fault as ref_fault  # noqa: E402
from repro.core.partition import uniform_partition as ref_uniform  # noqa: E402
from repro_torch.checkpoint.replication_store import ReplicatedCheckpointer  # noqa: E402
from repro_torch.core import fault  # noqa: E402
from repro_torch.core.partition import uniform_partition  # noqa: E402
from repro_torch.core.replication import (ReplicaStore, chain_target,  # noqa: E402
                                          should_chain, should_global)
from repro_torch.core.stash import VersionedWeights, tree_mean  # noqa: E402


def _p(v):
    return {"w": torch.full((3,), float(v))}


def test_versioned_weights_put_get_prune():
    vw = VersionedWeights(depth=2)
    for v in range(3):
        vw.put(v, _p(v))
    assert sorted(vw.versions) == [1, 2]
    assert vw.get(1)["w"][0].item() == 1.0
    assert vw.newest()["w"][0].item() == 2.0


def test_versioned_weights_get_falls_back_to_older():
    vw = VersionedWeights(depth=3)
    vw.put(3, _p(3))
    vw.put(5, _p(5))
    assert vw.get(4)["w"][0].item() == 3.0      # never a NEWER version
    assert vw.get(9)["w"][0].item() == 5.0
    assert vw.get(1)["w"][0].item() == 3.0      # nothing older: oldest


def test_versioned_weights_aggregate_collapses_and_bumps():
    vw = VersionedWeights(depth=3)
    for v in range(3):
        vw.put(v, _p(v))
    assert vw.aggregate()["w"][0].item() == pytest.approx(1.0)
    assert vw.live_versions() == [3]            # version jump (Fig. 2)


def test_tree_mean_keeps_dtype():
    m = tree_mean([_p(1), _p(2), _p(6)])
    assert m["w"][0].item() == pytest.approx(3.0)
    h = tree_mean([{"w": torch.full((2,), v, dtype=torch.bfloat16)}
                   for v in (1.0, 2.0)])
    assert h["w"].dtype == torch.bfloat16 and h["w"][0].item() == 1.5


def test_replication_schedule_and_ring():
    assert should_chain(50, 50) and not should_chain(49, 50)
    assert should_global(100, 100) and not should_global(50, 100)
    assert not should_chain(0, 50)
    assert chain_target(0, 3) == 1
    assert chain_target(2, 3) == 0              # last -> central


@pytest.mark.parametrize("holders,want", [
    ({2}, (100, "chain-w1", "chain")),          # fresh chain replica
    (set(), (50, "global-w1", "global")),       # chain holder dead too
])
def test_replica_store_recover(holders, want):
    rs = ReplicaStore()
    rs.do_chain(1, 100, "chain-w1")
    rs.do_global(1, 50, "global-w1")
    assert rs.recover(1, alive_chain_holders=holders, num_workers=3) == want
    assert ReplicaStore().recover(1, {2}, 3) is None


def test_checkpointer_consistent_batch_and_chain_preference():
    rc = ReplicatedCheckpointer(num_stages=3, chain_every=2, global_every=4)
    for b in range(1, 9):
        rc.maybe_replicate(b, lambda s: {"w": torch.full((2,), float(s))})
    assert rc.latest_consistent_batch(lost_stages=set()) == 8
    assert rc.latest_consistent_batch(lost_stages={1, 2}) == 8
    assert rc.recover_stage(1, lost_stages={2})[2] == "global"
    rc = ReplicatedCheckpointer(num_stages=3, chain_every=2,
                                global_every=100)
    for b in range(1, 7):
        rc.maybe_replicate(b, lambda s: {"w": torch.zeros(1)})
    r = rc.recover_stage(0, lost_stages=set())
    assert r[0] == 6 and r[2] == "chain"


def test_checkpointer_snapshot_is_not_the_live_tensor():
    """The reference snapshots immutable jax arrays; a torch tensor can be
    written in place later, so the stored replica must be a copy."""
    live = {"w": torch.zeros(2)}
    rc = ReplicatedCheckpointer(num_stages=1, chain_every=1, global_every=1)
    rc.maybe_replicate(1, lambda s: live)
    live["w"].add_(5.0)
    assert rc.recover_stage(0, lost_stages=set())[1]["w"].tolist() == \
        [0.0, 0.0]


def test_fault_classify_and_state_reset():
    assert fault.classify({1: "ok", 2: "ok"})[0] is fault.Case.ALL_NORMAL
    c, r = fault.classify({1: "restarted", 2: "ok"})
    assert c is fault.Case.ONE_RESTARTED and r == [1]
    c, d = fault.classify({1: None, 2: None})
    assert c is fault.Case.FAILURES and set(d) == {1, 2}
    st = fault.TrainingState(committed_forward_id=210,
                             committed_backward_id=204)
    st.enter_recovery()
    assert st.status == 1
    st.reset_after_recovery(failed_batch=205)
    assert (st.committed_forward_id, st.committed_backward_id,
            st.status) == (204, 204, 0)


def test_recovery_partition_homogeneous_fallback():
    r = fault.recovery_partition(np.ones(8), np.ones(8), np.ones(4),
                                 np.ones(3), have_profiles=False,
                                 num_alive=2)
    assert r.counts == (4, 4)


@pytest.mark.parametrize("layers,n,failed", [(9, 3, [1]), (12, 4, [1]),
                                             (8, 3, [2])])
def test_recovery_plans_cover_every_layer_as_the_reference(layers, n,
                                                           failed):
    alive = n - len(failed)
    p_cur = uniform_partition(layers, n).points
    p_new = uniform_partition(layers, alive).points
    plans = fault.recovery_plans(p_new, p_cur, failed, n)
    want = ref_fault.recovery_plans(ref_uniform(layers, alive).points,
                                    ref_uniform(layers, n).points, failed,
                                    n)
    assert len(plans) == alive
    covered = sorted(sum((p.local for p in plans), [])
                     + [l for p in plans for ls in p.need.values()
                        for l in ls])
    assert covered == list(range(layers))
    assert [(p.local, p.need) for p in plans] == \
        [(w.local, w.need) for w in want]
