"""Faults planted under the timed path, to show that the comparison
catches them (``correct`` comes out false), and the control.

Each is a function of the running driver, applied once set-up is done
and before the first timed request:

* ``store_drop_followers`` (the control): every replica but the front
  end (replica 0 where every replica fronts, as in a sharded
  deployment) persists nothing, which breaks the configuration's
  guarantee that an acknowledged request is in every replica's store;
* ``state_unchanged``: every protocol step hands back the state it was
  given, so nothing new is appended or committed;
* ``half_batch``: half of every batch the front end queues is left out;
* ``altered_answer``: one byte of a committed request is changed where
  the engine decodes it;
* ``misroute`` (``GROUP_FAULTS``, a sharded deployment only): the
  driver routes the keys of group 1 to group 0, so that group's rows
  ride another group's log.

A cell on one chip has no exchange between chips, so that fault does
not apply here."""

from __future__ import annotations

from typing import Callable, Dict


def store_drop_followers(d) -> None:
    lead = max(d.leader(), 0)
    for r, rt in enumerate(d.runtimes):
        if r != lead and rt.store is not None:
            rt.store.append_framed = lambda blob: 0


def state_unchanged(d) -> None:
    c = d.cluster
    c._store = lambda st: None


def half_batch(d) -> None:
    c = d.cluster
    submit = c.submit_many

    def halved(*args):
        *head, rows = args
        return submit(*head, list(rows)[::2])
    c.submit_many = halved


def altered_answer(d) -> None:
    c = d.cluster
    replay = c._replay_committed
    done = []

    def altered(*a, **k):
        out = replay(*a, **k)
        if done:
            return out
        for s in _streams(c.replayed):
            segs = [b for b in s.segments_from(0) if hasattr(b, "blob")]
            if segs and segs[-1].blob:
                b = segs[-1]
                blob = bytearray(b.blob)
                blob[-1] ^= 0x20
                b.blob = bytes(blob)
                done.append(1)
                break
        return out
    c._replay_committed = altered


def _streams(replayed):
    """Every replica's stream: ``replayed[r]``, or ``replayed[g][r]``
    over G groups."""
    for s in replayed:
        yield from (s if isinstance(s, list) else (s,))


def misroute(d) -> None:
    router = d.router
    group_of = router.group_of

    def wrong(key):
        g = group_of(key)
        return 0 if g == 1 else g
    router.group_of = wrong


FAULTS: Dict[str, Callable] = dict(
    store_drop_followers=store_drop_followers,
    state_unchanged=state_unchanged, half_batch=half_batch,
    altered_answer=altered_answer)

GROUP_FAULTS: Dict[str, Callable] = dict(misroute=misroute)
