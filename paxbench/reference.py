"""The plain reference that decides ``correct``.

It knows only what the harness generated and handed over (each
request's bytes, connection and send order) and the deployment's log
geometry, and works out on its own what every replica's committed
stream and stable store must hold. Then it
reads the program's outputs (acks, each replica's committed stream,
store file and device ring) only to judge them. Plain Python and
NumPy; it imports nothing of the program.

The guarantees held (the configuration's ``guarantees``): every request
is answered exactly once, and each connection's answers come in the
order its requests were sent; an acknowledged request is in the
committed log of every replica (so in a majority's), fragmented at the
slot width, in its connection's order, exactly once, with its bytes
unchanged, and nothing else is; all replicas hold one order; every
replica's stable store holds exactly its committed stream, record for
record. Over G groups (``judge_groups``) all of this holds group by
group, every connection's rows ride the one group the client sent them
to, and a CONNECT, which the sharded driver holds until its
connection's first SEND, is expected with that SEND. With interposed
apps (``judge_app``) the rule on each stream is on bytes (connection ids
are the proxy's), every replica's app must hold what a plain interpreter
of the committed stream (``toy_state``) holds, and no reply may reach a
client before its request is committed (``early_acks``).
"""

from __future__ import annotations

import difflib
import re
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

CONNECT, SEND = 2, 3
STORE_MAGIC = 0x52505353544F5231     # the store file's header tag

Entry = Tuple[int, int, bytes]       # (entry type, connection, payload)


def fragments(payload: bytes, slot_bytes: int) -> List[bytes]:
    """A request's log entries: slot-wide pieces, in order."""
    if not payload:
        return [b""]
    return [payload[i:i + slot_bytes]
            for i in range(0, len(payload), slot_bytes)]


def stream_entries(stream) -> Tuple[List[Entry], List[int]]:
    """A replica's committed stream (the program's output) as plain
    entries, read column by column from its batches, with each entry's
    absolute log index (-1 where a batch carries none)."""
    out: List[Entry] = []
    idx: List[int] = []
    for seg in stream.segments_from(0):
        if isinstance(seg, list):
            out.extend((int(t), int(c), bytes(p)) for t, c, _q, p in seg)
            idx.extend([-1] * len(seg))
            continue
        blob, offs = seg.blob, seg.offs.tolist()
        out.extend((t, c, blob[offs[i]:offs[i + 1]]) for i, (t, c) in
                   enumerate(zip(seg.types.tolist(), seg.conns.tolist())))
        idx.extend(seg.gidx.tolist() if seg.gidx is not None
                   else [-1] * len(seg))
    return out, idx


# the fused ring's row: ``slot_words`` payload words, then these metadata
# words (the log's documented layout)
M_TYPE, M_CONN, M_LEN, M_GIDX, META_W = 0, 2, 4, 5, 8


def log_errors(buf, end: int, entries: Sequence[Entry],
               index: Sequence[int]) -> int:
    """The device log of one replica against its committed stream: every
    client entry of the stream whose index the ring still holds (the
    last ``n_slots`` before ``end``) must sit in its slot, stamped with
    its index, with its type, connection and bytes; and no client entry
    the ring holds below the stream's last index may be missing from
    the stream. ``buf`` is the replica's ``[n_slots, words]`` int32
    ring (a tensor, read here)."""
    n_slots = buf.shape[0]
    lo = max(0, end - n_slots)
    keep = [i for i, g in enumerate(index) if g >= lo]
    if any(index[i] < 0 for i in keep) or (not keep and entries):
        return len(entries)
    if not keep:
        return 0
    hi = index[keep[-1]] + 1
    import torch
    slots = torch.arange(lo, hi, device=buf.device) % n_slots
    rows = buf.index_select(0, slots).cpu().numpy()
    sw = rows.shape[1] - META_W
    meta = rows[:, sw:]
    client = (meta[:, M_TYPE] >= CONNECT) & (meta[:, M_TYPE] <= 4)
    bad = int((meta[client, M_GIDX] != np.arange(lo, hi)[client]).sum())
    pos = np.nonzero(client)[0]
    data = np.ascontiguousarray(rows[pos, :sw]).view(np.uint8)
    lens = np.minimum(meta[pos, M_LEN], sw * 4).tolist()
    ring = [(int(t), int(c), data[i, :lens[i]].tobytes()) for i, (t, c)
            in enumerate(zip(meta[pos, M_TYPE].tolist(),
                             meta[pos, M_CONN].tolist()))]
    return bad + divergence([entries[i] for i in keep], ring)


def store_entries(path: str) -> List[Entry]:
    """A store file, parsed by its documented format: ``[u64 magic][u64
    base]`` then ``[u32 len][u8 type][i32 conn][payload]`` records."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    if len(data) >= 16 and struct.unpack_from("<Q", data)[0] == STORE_MAGIC:
        if struct.unpack_from("<Q", data, 8)[0] != 0:
            raise ValueError(f"{path}: a compacted store")
        pos = 16
    out: List[Entry] = []
    n = len(data)
    unpack = struct.unpack_from
    while pos + 4 <= n:
        ln, = unpack("<I", data, pos)
        if ln < 5 or pos + 4 + ln > n:
            break                     # a torn tail
        t, c = unpack("<Bi", data, pos + 4)
        out.append((t, c, data[pos + 9:pos + 4 + ln]))
        pos += 4 + ln
    return out


def expected_streams(conns: np.ndarray, pidx: np.ndarray,
                     status: np.ndarray, payloads: Sequence[bytes],
                     slot_bytes: int
                     ) -> Dict[int, List[Tuple[int, bytes, bool]]]:
    """Per connection, its entries in send order: a CONNECT where the
    row is one (pool index -1), else the request's fragments; each
    marked optional when the row was refused or failed (it may or may
    not have reached the log)."""
    exp: Dict[int, List[Tuple[int, bytes, bool]]] = {}
    frag_cache: Dict[int, List[bytes]] = {}
    for c, p, s in zip(conns.tolist(), pidx.tolist(), status.tolist()):
        lst = exp.setdefault(c, [])
        opt = s != 0
        if p < 0:
            lst.append((CONNECT, b"", opt))
            continue
        fr = frag_cache.get(p)
        if fr is None:
            fr = frag_cache[p] = fragments(payloads[p], slot_bytes)
        lst.extend((SEND, f, opt) for f in fr)
    return exp


def stream_errors(entries: Sequence[Entry],
                  expected: Dict[int, List[Tuple[int, bytes, bool]]],
                  notes: List[str]) -> int:
    """Entries of one committed stream that the expected per-connection
    sequences do not explain, plus the expected entries it lacks (an
    optional one, of a refused request, may be absent). Each
    connection's committed entries are aligned with its expected ones
    (longest matching blocks), so one fault counts once, not once per
    entry after it. The first few faults are described in ``notes``."""
    got: Dict[int, List[Tuple[int, bytes]]] = {}
    for t, c, p in entries:
        got.setdefault(c, []).append((t, p))
    bad = 0
    for c in set(got) | set(expected):
        g = got.get(c, [])
        e = expected.get(c)
        if e is None:
            bad += len(g)
            _note(notes, f"conn {c}: {len(g)} entries of no request sent")
            continue
        if len(g) == len(e) and all(x == (y[0], y[1])
                                    for x, y in zip(g, e)):
            continue
        sm = difflib.SequenceMatcher(None, g, [(y[0], y[1]) for y in e],
                                     autojunk=False)
        hit_e = set()
        matched = 0
        for blk in sm.get_matching_blocks():
            matched += blk.size
            hit_e.update(range(blk.b, blk.b + blk.size))
        lost = sum(1 for j, y in enumerate(e) if j not in hit_e and not y[2])
        extra = len(g) - matched
        if lost or extra:
            bad += lost + extra
            i = next((i for i, (x, y) in enumerate(zip(g, e))
                      if x != (y[0], y[1])), min(len(g), len(e)))
            _note(notes, f"conn {c}: {len(g)} committed, {len(e)} expected, "
                  f"{lost} lost, {extra} extra, first difference at {i}: "
                  f"got {g[i] if i < len(g) else None!r:.120} "
                  f"expected {e[i][:2] if i < len(e) else None!r:.120}")
    return bad


def _note(notes: List[str], msg: str, cap: int = 12) -> None:
    if len(notes) < cap:
        notes.append(msg)


def divergence(a: Sequence[Entry], b: Sequence[Entry]) -> int:
    """Positions at which two replicas' streams differ, and the length
    by which one outruns the other."""
    if a == b:
        return 0
    n = min(len(a), len(b))
    return sum(1 for i in range(n) if a[i] != b[i]) + abs(len(a) - len(b))


def ack_errors(conns: np.ndarray, order: np.ndarray,
               fired: np.ndarray) -> Dict[str, int]:
    """Answers: never came, came twice, or came out of the order in
    which their connection sent them."""
    done = fired > 0
    o = np.argsort(conns, kind="stable")          # send order per conn
    c, r, d = conns[o], order[o], done[o]
    same = (c[1:] == c[:-1]) & d[1:] & d[:-1]
    return dict(unanswered=int((~done).sum()),
                double_acks=int((fired > 1).sum()),
                ack_order=int((same & (r[1:] <= r[:-1])).sum()))


def judge(*, conns: np.ndarray, pidx: np.ndarray, status: np.ndarray,
          fired: np.ndarray, order: np.ndarray, payloads: Sequence[bytes],
          slot_bytes: int, streams: Sequence, stores: Sequence[str],
          logs: Sequence = (), ends: Sequence[int] = (),
          notes: Optional[List[str]] = None) -> Dict[str, int]:
    """Every number compared, each to be held at 0.

    ``conns``/``pidx``/``status``/``fired``/``order`` describe every
    row sent (a request, or a CONNECT where ``pidx`` is -1), in send
    order: its connection, pool index, the status of its answer, how
    many answers came, the answers' global order; ``streams[r]`` is
    replica r's committed stream, ``stores[r]`` its store file,
    ``logs[r]`` its device ring and ``ends[r]`` its end index (both
    read only once the run is over)."""
    notes = notes if notes is not None else []
    out = ack_errors(conns, order, fired)
    exp = expected_streams(conns, pidx, status, payloads, slot_bytes)
    read = [stream_entries(s) for s in streams]
    got = [e for e, _ in read]
    log_bad = sum(log_errors(buf, int(ends[r]), *read[r])
                  for r, buf in enumerate(logs))
    stream_bad = order_bad = 0
    for r, entries in enumerate(got):
        n = len(notes)
        stream_bad += stream_errors(entries, exp, notes)
        notes[n:] = [f"replica {r}: {m}" for m in notes[n:]]
        if r:
            order_bad += divergence(got[0], entries)
    store_bad = sum(divergence(got[r], store_entries(path))
                    for r, path in enumerate(stores))
    out.update(stream_mismatch=stream_bad, order_divergence=order_bad,
               store_mismatch=store_bad, log_mismatch=log_bad)
    return out


# ---- a sharded deployment: G groups, each with its own committed log ----

def expected_held(conns: np.ndarray, pidx: np.ndarray, status: np.ndarray,
                  payloads: Sequence[bytes], slot_bytes: int
                  ) -> Dict[int, List[Tuple[int, bytes, bool]]]:
    """``expected_streams`` where each CONNECT is held until its
    connection's first SEND: it is expected just before that SEND, with
    that SEND's fate (optional where the SEND was refused or failed),
    and not at all on a connection that never sent."""
    first: Dict[int, bool] = {}          # conn -> its first SEND optional
    for c, p, s in zip(conns.tolist(), pidx.tolist(), status.tolist()):
        if p >= 0 and c not in first:
            first[c] = s != 0
    exp = expected_streams(conns, pidx, status, payloads, slot_bytes)
    out: Dict[int, List[Tuple[int, bytes, bool]]] = {}
    for c, rows in exp.items():
        rest = [e for e in rows if e[0] != CONNECT]
        if c in first:
            rest.insert(0, (CONNECT, b"", first[c]))
        if rest:
            out[c] = rest
    return out


def judge_groups(*, conns: np.ndarray, pidx: np.ndarray,
                 status: np.ndarray, fired: np.ndarray, order: np.ndarray,
                 groups: np.ndarray, payloads: Sequence[bytes],
                 slot_bytes: int, streams: Sequence[Sequence],
                 stores: Sequence[str], logs: Sequence[Sequence] = (),
                 ends=(), notes: Optional[List[str]] = None
                 ) -> Dict[str, int]:
    """``judge`` over G groups. ``groups[i]`` is the group of row i's
    connection (the one the client sent it on); ``streams[g][r]``,
    ``logs[g][r]`` and ``ends[g][r]`` are group g's on replica r;
    ``stores[r]`` is replica r's one store file, which holds all its
    groups' records.

    Every connection's rows must lie in its own group's stream, on
    every replica: a row found in another group's counts under
    ``route_mismatch`` (and is missing from its own). The stream, order
    and log numbers are taken for each group and summed. A store record
    names no group, but its connection does: each group's records in a
    replica's store, in store order, must be that group's committed
    stream on that replica; a record of no connection sent counts under
    ``store_mismatch``."""
    notes = notes if notes is not None else []
    out = ack_errors(conns, order, fired)
    exp = expected_held(conns, pidx, status, payloads, slot_bytes)
    group_of = dict(zip(conns.tolist(), groups.tolist()))
    G = len(streams)
    exp_g: List[Dict] = [{} for _ in range(G)]
    for c, rows in exp.items():
        exp_g[group_of[c]][c] = rows
    route_bad = stream_bad = order_bad = log_bad = store_bad = 0
    got: List[List[List[Entry]]] = []
    for g, row in enumerate(streams):
        got.append([])
        for r, s in enumerate(row):
            entries, idx = stream_entries(s)
            if logs:
                log_bad += log_errors(logs[g][r], int(ends[g][r]),
                                      entries, idx)
            own = [e for e in entries if group_of.get(e[1], g) == g]
            if len(own) != len(entries):
                route_bad += len(entries) - len(own)
                _note(notes, f"group {g} replica {r}: "
                      f"{len(entries) - len(own)} entries of other groups")
            n = len(notes)
            stream_bad += stream_errors(own, exp_g[g], notes)
            notes[n:] = [f"group {g} replica {r}: {m}" for m in notes[n:]]
            if r:
                order_bad += divergence(got[g][0], entries)
            got[g].append(entries)
    for r, path in enumerate(stores):
        per_g: List[List[Entry]] = [[] for _ in range(G)]
        for e in store_entries(path):
            g = group_of.get(e[1])
            if g is None:
                store_bad += 1
            else:
                per_g[g].append(e)
        store_bad += sum(divergence(got[g][r], per_g[g]) for g in range(G))
    out.update(stream_mismatch=stream_bad, order_divergence=order_bad,
               store_mismatch=store_bad, log_mismatch=log_bad,
               route_mismatch=route_bad)
    return out


# ---- an interposed app: clients over TCP, the app's state read back ----

CLOSE = 4
TOY_SET = re.compile(rb"SET\s+(\S{1,63})\s+([^\n]{1,255})")
TOY_DEL = re.compile(rb"DEL\s+(\S{1,63})")


def toy_state(entries: Sequence[Entry]) -> Dict[bytes, bytes]:
    """What ``native/toyserver.c`` holds after executing a committed
    stream, worked out plainly: each connection's SEND bytes are cut
    into lines as the app cuts them, and each line is applied in stream
    order (``SET k v``, ``DEL k``; reads change nothing)."""
    state: Dict[bytes, bytes] = {}
    pend: Dict[int, bytes] = {}
    for t, c, p in entries:
        if t == SEND:
            *lines, pend[c] = (pend.get(c, b"") + p).split(b"\n")
            for line in lines:
                m = TOY_SET.match(line)
                if m:
                    state[m.group(1)] = m.group(2)
                    continue
                m = TOY_DEL.match(line)
                if m:
                    state.pop(m.group(1), None)
        else:
            pend.pop(c, None)
    return state


def _joined(entries: Sequence[Entry]) -> Tuple[Dict[int, List[int]],
                                                Dict[int, bytes]]:
    """Per connection of a stream: its entries' types, and its SEND
    bytes joined."""
    types: Dict[int, List[int]] = {}
    parts: Dict[int, List[bytes]] = {}
    for t, c, p in entries:
        types.setdefault(c, []).append(t)
        if t == SEND:
            parts.setdefault(c, []).append(p)
    return types, {c: b"".join(parts.get(c, ())) for c in types}


def app_stream_errors(entries: Sequence[Entry],
                      sent: Sequence[bytes], need: Sequence[int],
                      notes: List[str]) -> int:
    """One replica's committed stream against the bytes each client
    connection sent. Connection ids are the proxy's and the shim
    forwards whatever ``read()`` returned, so the rule is on bytes:
    every connection of the stream opens with its CONNECT and ends at
    most with one CLOSE; its SEND bytes, joined, must be a prefix of the
    bytes of exactly one client connection (``sent[k]``); each client
    connection is matched by at most one connection of the stream, which
    must cover its first ``need[k]`` bytes (through its last acked
    request); and the stream holds no more connections than the clients
    opened."""
    types, joined = _joined(entries)
    bad = 0
    if len(types) > len(sent):
        bad += len(types) - len(sent)
        _note(notes, f"{len(types)} connections, {len(sent)} opened")
    match: Dict[int, List[int]] = {k: [] for k in range(len(sent))}
    for c, ts in types.items():
        if (ts[0] != CONNECT or CONNECT in ts[1:] or CLOSE in ts[:-1]
                or any(t not in (CONNECT, SEND, CLOSE) for t in ts)):
            bad += 1
            _note(notes, f"conn {c}: events out of order: {ts[:8]}")
        b = joined[c]
        if not b:
            continue
        hits = [k for k, s in enumerate(sent) if s.startswith(b)]
        if len(hits) != 1:
            bad += 1
            _note(notes, f"conn {c}: {len(b)} B sent by {len(hits)} "
                  f"client connections: {b[:60]!r}")
        else:
            match[hits[0]].append(c)
    for k, cs in match.items():
        if len(cs) > 1:
            bad += 1
            _note(notes, f"client connection {k}: in conns {cs}")
        got = max((len(joined[c]) for c in cs), default=0)
        if got < need[k]:
            bad += 1
            _note(notes, f"client connection {k}: {got} B committed, "
                  f"{need[k]} B acked")
    return bad


def early_acks(entries: Sequence[Entry], sent: Sequence[bytes],
               acks: Sequence[Tuple[np.ndarray, np.ndarray]],
               absent_t: np.ndarray, absent_n: np.ndarray,
               notes: List[str]) -> int:
    """Acked requests whose ``+OK`` reached the client before the
    request's last byte was in any replica's committed stream: the
    guarantee that a reply leaves only once its input is committed
    (speculative output commit). ``entries`` is the leader's committed
    stream; ``acks[k]`` gives client connection k's acked requests as
    the offset just past each one's last byte in the connection's bytes
    (``sent[k]``) and the time its answer arrived. At time
    ``absent_t[j]`` no replica's committed stream held an entry from
    index ``absent_n[j]`` on. A request whose last byte lies in entry i
    counts where its answer arrived before the latest such time with
    ``absent_n[j] <= i``. A request the stream does not hold is
    ``stream_mismatch``'s to count."""
    order = np.argsort(absent_n, kind="stable")
    ns = absent_n[order]
    ts = np.maximum.accumulate(absent_t[order]) if ns.size else ns
    _types, joined = _joined(entries)
    ends: Dict[int, List[int]] = {}
    index: Dict[int, List[int]] = {}
    for i, (t, c, p) in enumerate(entries):
        if t == SEND:
            e = ends.setdefault(c, [])
            e.append((e[-1] if e else 0) + len(p))
            index.setdefault(c, []).append(i)
    early = 0
    for c, e in ends.items():
        hits = [k for k, s in enumerate(sent) if s.startswith(joined[c])]
        if len(hits) != 1:
            continue
        off, t_ack = acks[hits[0]]
        pos = np.searchsorted(np.asarray(e), off, side="left")
        held = pos < len(e)
        entry = np.asarray(index[c])[pos[held]]
        j = np.searchsorted(ns, entry, side="right")
        seen = j > 0
        gone = ts[j[seen] - 1]
        n = int((t_ack[held][seen] < gone).sum())
        if n:
            _note(notes, f"conn {c}: {n} answers before their request "
                  "was committed")
        early += n
    return early


def judge_app(*, conn: np.ndarray, pidx: np.ndarray, answer: np.ndarray,
              t_ack: np.ndarray, extra_replies: int, n_conns: int,
              payloads: Sequence[bytes],
              streams: Sequence[Sequence[Entry]],
              stores: Sequence[Sequence[Entry]], log_bad: int, lead: int,
              absent_t: np.ndarray, absent_n: np.ndarray,
              dumps: Sequence[Optional[Dict[bytes, bytes]]],
              notes: Optional[List[str]] = None) -> Dict[str, int]:
    """Every number compared for an interposed app, each to be held at
    0. ``conn``/``pidx``/``answer``/``t_ack`` describe every request the
    clients sent, in send order: its client connection (0 to
    ``n_conns`` - 1), pool index, answer (0 none, 1 ``+OK``, 2 another
    line, 3 failed: the app severed the connection) and when the answer
    arrived; ``extra_replies`` counts lines that answered no request.
    ``streams[r]`` and ``stores[r]`` are replica r's committed stream
    and store, read once the clients were done and the streams had
    settled; ``log_bad`` is ``log_errors`` summed over the replicas'
    rings; ``lead`` the replica that led; ``absent_t``/``absent_n`` the
    commit clock's stamps (``early_acks``); ``dumps[r]`` replica r's
    app's whole state, read back (None where it gave none)."""
    notes = notes if notes is not None else []
    sent: List[List[bytes]] = [[] for _ in range(n_conns)]
    size, need = [0] * n_conns, [0] * n_conns
    offs: List[List[int]] = [[] for _ in range(n_conns)]
    rows: List[List[int]] = [[] for _ in range(n_conns)]
    for i, (k, p, a) in enumerate(zip(conn.tolist(), pidx.tolist(),
                                      answer.tolist())):
        sent[k].append(payloads[p])
        size[k] += len(payloads[p])
        if a == 1:
            need[k] = size[k]
            offs[k].append(size[k])
            rows[k].append(i)
    sent_b = [b"".join(s) for s in sent]
    out = dict(unanswered=int((answer == 0).sum()),
               bad_reply=int((answer == 2).sum()) + int(extra_replies))
    stream_bad = order_bad = 0
    for r, entries in enumerate(streams):
        n = len(notes)
        stream_bad += app_stream_errors(entries, sent_b, need, notes)
        notes[n:] = [f"replica {r}: {m}" for m in notes[n:]]
        if r:
            order_bad += divergence(streams[0], entries)
    store_bad = sum(divergence(e, s) for e, s in zip(streams, stores))
    acks = [(np.asarray(o, np.int64), t_ack[np.asarray(i, np.int64)])
            for o, i in zip(offs, rows)]
    early = early_acks(streams[lead], sent_b, acks, absent_t, absent_n,
                       notes)
    state = toy_state(streams[lead])
    app_bad = 0
    for r, got in enumerate(dumps):
        if got is None:
            app_bad += len(state) + 1
            _note(notes, f"app {r}: no state read back")
            continue
        wrong = [k for k in state.keys() | got.keys()
                 if got.get(k) != state.get(k)]
        app_bad += len(wrong)
        if wrong:
            k = min(wrong)
            _note(notes, f"app {r}: {len(wrong)} of {len(state)} keys "
                  f"differ, first {k!r}: got {got.get(k)!r} expected "
                  f"{state.get(k)!r}")
    out.update(stream_mismatch=stream_bad, order_divergence=order_bad,
               store_mismatch=store_bad, log_mismatch=int(log_bad),
               early_acks=early, app_mismatch=app_bad)
    return out
