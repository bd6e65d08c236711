"""Live membership change — join / upsize / downsize via joint consensus.

Reference (§3.5): a joiner multicasts JOIN; the leader allocates a slot or
up-sizes the group (``handle_server_join_request``,
``dare_ibv_ud.c:972-1068``), appends a CONFIG entry, and drives the config
state machine EXTENDED → TRANSIT → STABLE through committed CONFIG entries
(``apply_committed_entries`` ``dare_server.c:1861-1937``), requiring BOTH
majorities while transitional (``CID_TRANSIT``, ``dare_config.h:17-24``).

Here a CONFIG log entry's payload is four int32 words
``[bitmask_old, bitmask_new, cid_state, epoch]``; replicas adopt the newest
config present in their log immediately on append/absorb (the device-side
scan in ``consensus/step.py`` Phase G — matching ``poll_config_entries``),
while quorum rules switch to dual-majority the moment the TRANSIT entry is
in the leader's log. The host-side manager below drives the two-phase
change: submit TRANSIT, wait for commit, submit STABLE.

The port's copy of the JAX package's ``consensus/membership.py``. The
state's u32 bitmasks are int64 tensors holding the unsigned value, so
:meth:`MembershipManager.current` reads the same integers as the JAX
module, and :func:`config_payload` packs a mask with bit 31 set as its
u32 bit pattern.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from rdma_paxos_tpu_torch.consensus.state import ConfigState


def config_payload(bitmask_old: int, bitmask_new: int, cid_state: int,
                   epoch: int) -> bytes:
    """Four little-endian i32 words; a u32 bitmask with bit 31 set
    travels as its bit pattern (the device reads it back as u32).
    ``cid_state`` and ``epoch`` outside the i32 range raise."""
    masks = np.array([bitmask_old, bitmask_new], dtype="<u4").view("<i4")
    rest = np.array([cid_state, epoch], dtype="<i4")
    return masks.tobytes() + rest.tobytes()


class MembershipManager:
    """Drives joint-consensus membership changes on a cluster harness
    (SimCluster or ClusterDriver.cluster)."""

    def __init__(self, cluster):
        self.cluster = cluster

    def current(self, r: int = 0):
        st = self.cluster.state
        return dict(
            bitmask_old=int(st.bitmask_old[r]),
            bitmask_new=int(st.bitmask_new[r]),
            cid_state=int(st.cid_state[r]),
            epoch=int(st.epoch[r]),
        )

    def change(self, leader: int, new_mask: int, *,
               max_steps: int = 50) -> None:
        """Two-phase change to ``new_mask``: TRANSIT (dual quorum), then
        STABLE once the transitional entry committed. Blocking; steps the
        cluster (driver integration calls the phases separately)."""
        cur = self.current(leader)
        old_mask = cur["bitmask_new"]
        if old_mask == new_mask:
            return
        epoch = cur["epoch"]
        self.submit_transit(leader, old_mask, new_mask, epoch + 1)
        target = self._step_until_config(leader,
                                         int(ConfigState.TRANSIT),
                                         epoch + 1, max_steps)
        # TRANSIT is in the log and committed -> finalize
        self.submit_stable(leader, new_mask, epoch + 2)
        self._step_until_config(leader, int(ConfigState.STABLE),
                                epoch + 2, max_steps)
        del target

    def join(self, leader: int, joiner: int, *,
             max_steps: int = 50) -> None:
        """Three-phase joiner admission: EXTENDED (joiner replicates,
        old quorum) → TRANSIT (dual quorum) → STABLE — the full
        reference join ladder (``handle_server_join_request`` →
        ``apply_committed_entries`` EXTENDED→TRANSIT→STABLE,
        ``dare_server.c:1861-1937``). Blocking; the driver integration
        drives the same phases incrementally."""
        cur = self.current(leader)
        old_mask = cur["bitmask_new"]
        if (old_mask >> joiner) & 1:
            return
        epoch = cur["epoch"]
        self.submit_extended(leader, old_mask, joiner, epoch + 1)
        self._step_until_config(leader, int(ConfigState.EXTENDED),
                                epoch + 1, max_steps)
        # EXTENDED committed ⟹ the joiner is inside the replication
        # window fan-out; it must actually CATCH UP before it may count
        # toward quorum (a joiner whose lag exceeds window_slots can
        # never catch up passively — it needs snapshot recovery first,
        # exactly the reference's joiner SM-recovery prerequisite,
        # dare_ibv_rc.c:603-710)
        for _ in range(max_steps):
            st = self.cluster.state
            if int(st.end[joiner]) >= int(st.end[leader]):
                break
            self.cluster.step()
        else:
            raise TimeoutError(
                f"joiner {joiner} did not catch up within {max_steps} "
                "steps (lag beyond window_slots requires snapshot "
                "recovery before join)")
        # joiner caught up: flip to dual quorum
        self.submit_transit(leader, old_mask, old_mask | (1 << joiner),
                            epoch + 2)
        self._step_until_config(leader, int(ConfigState.TRANSIT),
                                epoch + 2, max_steps)
        self.submit_stable(leader, old_mask | (1 << joiner), epoch + 3)
        self._step_until_config(leader, int(ConfigState.STABLE),
                                epoch + 3, max_steps)

    def submit_extended(self, leader: int, old_mask: int, joiner: int,
                        epoch: int) -> None:
        """Announce an up-size for ``joiner`` (EXTENDED): the joiner is
        added to ``bitmask_new`` so it receives the replication window
        and counts in the pruning floor, but quorum stays on
        ``bitmask_old`` until the leader submits TRANSIT — the
        reference's EXTENDED config (``dare_ibv_ud.c:1024-1037``)."""
        from rdma_paxos_tpu_torch.consensus.log import EntryType
        self.cluster.submit(
            leader,
            config_payload(old_mask, old_mask | (1 << joiner),
                           int(ConfigState.EXTENDED), epoch),
            EntryType.CONFIG)

    def submit_transit(self, leader: int, old_mask: int, new_mask: int,
                       epoch: int) -> None:
        from rdma_paxos_tpu_torch.consensus.log import EntryType
        self.cluster.submit(
            leader,
            config_payload(old_mask, new_mask,
                           int(ConfigState.TRANSIT), epoch),
            EntryType.CONFIG)

    def submit_stable(self, leader: int, new_mask: int,
                      epoch: int) -> None:
        from rdma_paxos_tpu_torch.consensus.log import EntryType
        self.cluster.submit(
            leader,
            config_payload(new_mask, new_mask,
                           int(ConfigState.STABLE), epoch),
            EntryType.CONFIG)

    def _step_until_config(self, leader: int, want_state: int,
                           want_epoch: int, max_steps: int):
        """Step until the leader's applied config reaches (state, epoch)
        AND the config entry itself is committed (commit >= its index)."""
        for _ in range(max_steps):
            res = self.cluster.step()
            cur = self.current(leader)
            if (cur["epoch"] >= want_epoch
                    and cur["cid_state"] == want_state
                    and int(res["commit"][leader]) >= int(res["end"][leader])):
                return cur
        raise TimeoutError(
            f"config change to state={want_state} epoch={want_epoch} "
            f"did not commit in {max_steps} steps")
