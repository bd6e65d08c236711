"""APUS as deployed (a configuration with ``"runner": "app"``): each
replica's app is a process of its own, an unmodified TCP server
(``native/toyserver.c``, poll mode) under ``LD_PRELOAD=interpose.so``,
whose ``accept``/``read``/``close`` go over a Unix socket to its
replica's proxy (``proxy<r>.sock`` in the work directory) and whose
replies the shim holds until their input commits (speculative output
commit, the shim's default). The clients speak TCP to the leader's app
from a process of their own (``paxbench/appclient.py``); the followers'
apps get the committed bytes by the driver's loopback replay.

Set-up builds the shim and the app from the sources and flags the
configuration's ``app`` section names into ``build/paxbench_native/``
(again only when a source changes), builds
the ``ClusterDriver`` as ``cell.build_driver`` does with ``app_ports``,
starts the apps, elects, connects the clients, and refuses to measure
unless every client connection shows as a replicated CONNECT in the
leader's committed stream. The window, drain, settle, phases, collector,
trace and ``setup_s`` are ``cell.window``'s and ``cell.result``'s, so
every reader means here what it means in the other cells.

Before the warm-up the engine's decodes of newly committed entries are
stamped (``CommitClock``), so the judge can tell whether a reply left
the leader's app before its request's bytes were in any replica's
committed stream (``early_acks``: speculative output commit).

Once the clients are done sending (they stay connected until the
read-back is over) and the streams have come to rest, every replica's
committed stream and store are read, and then each app's whole state:
a barrier (``ReplayEngine.barrier`` with an ``ECHO`` probe on every
replay connection) proves the app consumed every replayed byte, then
``DUMPALL`` lists every key, both through the connections the driver's
own app checkpoint uses, which no replica replicates (a leader deposed
while a replicated read is in flight quarantines its app). The apps and
the client process are killed in a ``finally``, on a run that raises
too."""

from __future__ import annotations

import contextlib
import hashlib
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from paxbench import appclient, reference, spec
from paxbench.appclient import (CMD, CONNECTED, EXIT, FAILED, GO, LEADER,
                                N_ANSWERED, N_CONNS, N_ROWS, OK, OVERFLOW,
                                RECONNECTS, SEVERED, STATE, STOP)
from paxbench.cell import (LEADER_HOLD_S, SETTLE_S, Marks, _stable_leader,
                           _settled, _terms, _wait, build_driver, result,
                           say, window)

CONNECT_S = 30.0        # the clients' connections, then their CONNECTs
QUIET_S = 0.3           # streams unchanged this long count as at rest
MIN_RTT_S = 0.001       # no request is answered sooner: it waits for a
                        # protocol step, so a closed loop sends at most
                        # clients x outstanding / MIN_RTT_S requests a second


def build_native(app: dict, root: Path = spec.ROOT) -> Dict[str, str]:
    """The shim and the app built from the sources and with the flags
    the configuration's ``app`` section names, into
    ``build/paxbench_native/`` (never into ``native/``); each is built
    again only when its source or flags hash differently from the stamp
    beside it. The app's flags carry ``-U_FORTIFY_SOURCE``: GCC on the
    card's machine fortifies ``read`` into ``__read_chk``, which the
    shim does not hook (nothing would replicate). Returns each binary's
    path."""
    out = root / "build" / "paxbench_native"
    out.mkdir(parents=True, exist_ok=True)
    recipes = {"interpose.so": (app["shim"], app["cxx"], app["shim_libs"]),
               "toyserver": (app["program"], app["cc"], [])}
    paths = {}
    for name, (src, flags, libs) in recipes.items():
        source = root / src
        digest = hashlib.sha256(source.read_bytes() + "\0".join(
            flags + libs).encode()).hexdigest()
        binary, stamp = out / name, out / f"{name}.sha256"
        if not (binary.is_file() and stamp.is_file()
                and stamp.read_text() == digest):
            tmp = out / f"{name}.tmp"
            pr = subprocess.run(flags + ["-o", str(tmp), str(source)] + libs,
                                capture_output=True, text=True, timeout=300)
            if pr.returncode:
                raise RuntimeError(f"building {name} failed:\n"
                                   f"{pr.stderr[-2000:]}")
            os.replace(tmp, binary)
            stamp.write_text(digest)
        paths[name] = str(binary)
    return paths


def free_ports(n: int) -> List[int]:
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


class Apps:
    """The replicas' apps, each in a session of its own, its output in
    ``app<r>.log`` in the work directory."""

    def __init__(self, bins: Dict[str, str], ports: Sequence[int],
                 workdir: str):
        self.logs = [os.path.join(workdir, f"app{r}.log")
                     for r in range(len(ports))]
        self.procs: List[subprocess.Popen] = []
        for r, port in enumerate(ports):
            env = dict(os.environ, LD_PRELOAD=bins["interpose.so"],
                       RP_PROXY_SOCK=os.path.join(workdir, f"proxy{r}.sock"))
            env.pop("RP_SPEC", None)      # speculative output commit
            with open(self.logs[r], "wb") as log:
                self.procs.append(subprocess.Popen(
                    [bins["toyserver"], str(port)], env=env,
                    stdin=subprocess.DEVNULL, stdout=log,
                    stderr=subprocess.STDOUT, start_new_session=True))

    def _log(self, r: int) -> bytes:
        with open(self.logs[r], "rb") as f:
            return f.read()

    def wait_listening(self, timeout: float) -> None:
        end = time.monotonic() + timeout
        for r, p in enumerate(self.procs):
            while b"listening on" not in self._log(r):
                if p.poll() is not None or time.monotonic() > end:
                    raise RuntimeError(f"app {r} is not listening: "
                                       f"{self._log(r)[-500:]!r}")
                time.sleep(0.01)

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait(10)


class LeaderFile(threading.Thread):
    """Publishes the replica that leads in the shared file's header,
    where a client that must reconnect reads it."""

    def __init__(self, d, hdr: np.ndarray, period: float = 0.05):
        super().__init__(daemon=True, name="paxbench-leader")
        self.d, self.hdr, self.period = d, hdr, period
        self.hdr[LEADER] = d.leader()
        self._halt = threading.Event()

    def run(self) -> None:
        while not self._halt.wait(self.period):
            self.hdr[LEADER] = self.d.leader()

    def stop(self) -> None:
        self._halt.set()
        self.join(5)


class AppLoop:
    """The client process, seen through the shared file as ``cell.window``
    sees a loop (``start``, ``close``, ``answered``, ``n_sent``,
    ``join``)."""

    def __init__(self, sh: appclient.Shared, pool_path: str,
                 ports: Sequence[int], traffic: dict):
        self.sh = sh
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "paxbench.appclient",
             "--shared", sh.path, "--cap", str(sh.cap),
             "--pool", pool_path, "--ports", ",".join(map(str, ports)),
             "--clients", str(int(traffic["clients"])),
             "--outstanding", str(int(traffic["outstanding"]))],
            cwd=str(spec.ROOT), stdin=subprocess.DEVNULL,
            stdout=subprocess.DEVNULL, start_new_session=True)

    def wait_connected(self, timeout: float) -> None:
        _wait(lambda: int(self.sh.hdr[STATE]) in (CONNECTED, FAILED)
              or self.proc.poll() is not None, timeout,
              "the clients did not connect to the leader's app")
        if int(self.sh.hdr[STATE]) != CONNECTED:
            raise RuntimeError("the clients could not connect to the "
                               "leader's app")

    def start(self) -> None:
        self.sh.hdr[CMD] = GO

    def close(self) -> None:
        self.sh.hdr[CMD] = STOP

    @property
    def n_sent(self) -> int:
        return int(self.sh.hdr[N_ROWS])

    def answered(self) -> int:
        return int(self.sh.hdr[N_ANSWERED])

    def join(self, timeout: float) -> bool:
        """The clients send nothing after ``close``. They keep their
        connections open until ``exit``, after the apps are read back:
        a client that hangs up sends a CLOSE, and a leader deposed while
        one is in flight quarantines its app."""
        return self.proc.poll() is None

    def exit(self, timeout: float) -> None:
        self.sh.hdr[CMD] = EXIT
        self.proc.wait(timeout)

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(10)


def replicated_connects(d, r: int) -> int:
    """CONNECT entries in replica r's committed stream."""
    entries, _ = reference.stream_entries(d.cluster.replayed[r])
    return sum(1 for e in entries if e[0] == reference.CONNECT)


def _committed(d, sh: appclient.Shared, payloads: Sequence[bytes],
               timeout: float = SETTLE_S) -> None:
    """Until the leader's committed stream holds as many SEND bytes as
    the acked requests sent: at once where every answer waited for its
    commit."""
    n = int(sh.hdr[N_ROWS])
    lens = np.fromiter((len(p) for p in payloads), np.int64, len(payloads))
    want = int(lens[sh.pidx[:n][sh.answer[:n] == OK]].sum())

    def held() -> bool:
        entries, _ = reference.stream_entries(
            d.cluster.replayed[max(d.leader(), 0)])
        return sum(len(p) for t, _c, p in entries
                   if t == reference.SEND) >= want
    try:
        _wait(held, timeout, "", poll=0.05)
    except TimeoutError:
        say("the leader's stream does not hold every acked byte")


def _at_rest(d, timeout: float = SETTLE_S) -> None:
    """Until every replica's stream has one length, unchanged for
    ``QUIET_S``: the replay into the apps and the stores' appends of
    the last entries are done."""
    end = time.monotonic() + timeout
    last, since = None, time.monotonic()
    while time.monotonic() < end:
        cur = [len(s) for s in d.cluster.replayed]
        if cur != last:
            last, since = cur, time.monotonic()
        elif time.monotonic() - since >= QUIET_S and len(set(cur)) == 1:
            return
        time.sleep(0.01)
    say("the replicas' streams did not come to rest")


def _probe(sock: socket.socket) -> None:
    """The barrier's probe on one replay connection: an ``ECHO`` whose
    answer, read past the answers to earlier replayed requests, shows
    the app has read every byte sent on it before."""
    sock.sendall(b"ECHO paxbench-barrier\n")
    buf = b""
    while b"=paxbench-barrier\n" not in buf:
        chunk = sock.recv(65536)
        if not chunk:
            raise OSError("the app closed a replay connection")
        buf = buf[-32:] + chunk


def read_back(replay, timeout: float = 30.0) -> Optional[Dict[bytes, bytes]]:
    """One app's whole state: once ``ReplayEngine.barrier`` shows the
    app consumed every replayed byte, its ``DUMPALL`` listing (``<key>
    <value>`` lines, then ``.``), over an out-of-band connection of its
    replica's own (``ReplayEngine.raw_conn``, the one the driver's app
    checkpoint uses), which the CONNECT gate passes through on every
    replica, leader or follower, so no read is replicated. None where
    the app cannot be reached or hangs up before the end."""
    try:
        replay.barrier(_probe, timeout)
        state: Dict[bytes, bytes] = {}
        with replay.raw_conn() as s, s.makefile("rb") as f:
            s.settimeout(timeout)
            s.sendall(b"DUMPALL\n")
            for line in f:
                if line == b".\n":
                    return state
                k, _, v = line.rstrip(b"\n").partition(b" ")
                state[k] = v
    except OSError as exc:
        say(f"read-back: {exc!r}")
    return None


class CommitClock:
    """Stamps each of the engine's decodes of newly committed entries
    (``_replay_committed``): just before it, the time and then the
    longest committed stream of any replica, so every entry from that
    index on was in no replica's committed stream at that time. A
    reply released at commit comes after the decode that appended its
    request's last byte, hence after every stamp that shows that byte
    absent (``reference.early_acks``)."""

    def __init__(self, cluster):
        self.t: List[float] = []
        self.n: List[int] = []
        inner = cluster._replay_committed

        def stamped(*a, **k):
            self.t.append(time.perf_counter())
            self.n.append(max(len(s) for s in cluster.replayed))
            return inner(*a, **k)
        cluster._replay_committed = stamped

    def arrays(self):
        k = min(len(self.t), len(self.n))
        return np.asarray(self.t[:k]), np.asarray(self.n[:k], np.int64)


def cpu_s(pids: Sequence[int]) -> List[float]:
    """Each process's CPU seconds so far (user and system), from
    ``/proc/<pid>/stat``; -1 where it cannot be read."""
    tick = os.sysconf("SC_CLK_TCK")
    out = []
    for pid in pids:
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rpartition(")")[2].split()
            out.append((int(fields[11]) + int(fields[12])) / tick)
        except (OSError, ValueError, IndexError):
            out.append(-1.0)
    return out


def _tail(workdir: str, r: int) -> str:
    with open(os.path.join(workdir, f"replica{r}.log")) as f:
        return f.read()[-600:]


def run(cell: dict, *, seed: int, seconds: float, trace: bool, device,
        workdir: str, t_start: float, fault=None, drain_s: float = 60.0,
        trace_s: float = 10.0) -> Dict:
    conf, traffic = cell["config"], cell["traffic"]
    R = int(conf["replicas"])
    if len(os.path.join(workdir, "proxy0.sock")) > 100:
        raise ValueError(f"work directory too long for a Unix socket: "
                         f"{workdir}")
    mark = Marks()
    mark("start")
    pool = spec.generator(traffic["kind"]).make(traffic, seed)
    mark("traffic")
    bins = build_native(conf["app"])
    mark("build")
    ports = free_ports(R)
    in_flight = int(traffic["clients"]) * int(traffic["outstanding"])
    sh = appclient.Shared(os.path.join(workdir, "clients.bin"),
                          int(in_flight / MIN_RTT_S * (seconds + 60)),
                          create=True)
    sh.hdr[LEADER] = -1
    pool_path = os.path.join(workdir, "pool.bin")
    appclient.write_pool(pool_path, pool.payloads)
    d = build_driver(conf, device, workdir, app_ports=ports)
    apps = clients = publisher = None
    with contextlib.ExitStack() as cleanup:
        # run last to first, each whatever the others raise: the
        # publisher, the clients, the driver, the apps
        cleanup.callback(lambda: apps is not None and apps.kill())
        cleanup.callback(d.stop)
        cleanup.callback(lambda: clients is not None and clients.kill())
        cleanup.callback(lambda: publisher is not None and publisher.stop())
        apps = Apps(bins, ports, workdir)
        apps.wait_listening(10)
        # every process is started before the profiler is: with the
        # client forked after it, 2 of 5 traced runs kept few kernels
        clients = AppLoop(sh, pool_path, ports, traffic)
        mark("apps")
        d.prewarm()
        if trace:
            from paxbench.trace import warm_profiler
            warm_profiler()
        mark("prewarm")
        d.run()
        lead = _stable_leader(d, LEADER_HOLD_S, 60)
        mark("election")
        publisher = LeaderFile(d, sh.hdr)
        publisher.start()
        clients.wait_connected(CONNECT_S)
        n_clients = int(traffic["clients"])
        try:
            _wait(lambda: replicated_connects(d, lead) >= n_clients,
                  CONNECT_S, "", poll=0.05)
        except TimeoutError:
            raise RuntimeError(
                f"app not interposed: {replicated_connects(d, lead)} of "
                f"{n_clients} client connections show as a replicated "
                "CONNECT in the leader's committed stream") from None
        mark("connect")
        clock = CommitClock(d.cluster)
        pids = [p.pid for p in apps.procs] + [clients.proc.pid]
        cpu0, t_cpu0 = cpu_s(pids), time.perf_counter()
        w = window(d, clients, traffic=traffic, seconds=seconds,
                   trace=trace, workdir=workdir, t_start=t_start,
                   fault=fault, drain_s=drain_s, trace_s=trace_s,
                   device=device, settled=_settled, mark=mark)
        cpu1, t_cpu1 = cpu_s(pids), time.perf_counter()
        _committed(d, sh, pool.payloads)
        _at_rest(d)
        streams = [reference.stream_entries(s) for s in d.cluster.replayed]
        stores = [reference.store_entries(f"{workdir}/replica{r}.db")
                  for r in range(R)]
        t_ref = time.perf_counter()
        lead = d.leader() if d.leader() >= 0 else lead
        dumps = [read_back(rt.replay) for rt in d.runtimes]
        clients.exit(10)
        terms = _terms(d)
        for r, got in enumerate(dumps):
            if got is None:
                say(f"app {r} gave no state (leader {lead}, terms {terms}, "
                    f"exit code {apps.procs[r].poll()}, quarantined "
                    f"{d.runtimes[r].app_dirty}); replica logs: "
                    f"{[_tail(workdir, q) for q in range(R)]}")
    buf = d.cluster.state.log.buf
    ends = np.asarray(d.cluster.state.end.cpu()).ravel()
    log_bad = sum(reference.log_errors(buf[r], int(ends[r]), *streams[r])
                  for r in range(R))
    n = int(sh.hdr[N_ROWS])
    conn, answer = sh.conn[:n].copy(), sh.answer[:n].copy()
    t_ack = sh.t_ack[:n].copy()
    absent_t, absent_n = clock.arrays()
    notes: List[str] = []
    checks = reference.judge_app(
        conn=conn, pidx=sh.pidx[:n].copy(), answer=answer, t_ack=t_ack,
        extra_replies=int(sh.hdr[appclient.EXTRA_REPLIES]),
        n_conns=int(sh.hdr[N_CONNS]), payloads=pool.payloads,
        streams=[e for e, _ in streams], stores=stores, log_bad=log_bad,
        lead=lead, absent_t=absent_t, absent_n=absent_n, dumps=dumps,
        notes=notes)
    checks["overflow"] = int(sh.hdr[OVERFLOW])
    res = result(w, conf=conf, seconds=seconds, marks=mark.parts,
                 t_send=sh.t_send[:n].copy(), t_ack=t_ack,
                 sent=np.ones(n, bool), acked=answer == OK, checks=checks,
                 reconnects=int(sh.hdr[RECONNECTS]),
                 refused=int((answer == SEVERED).sum()),
                 reference_s=time.perf_counter() - t_ref, n_rows=n)
    res["diag"].update(
        leader=lead, terms_at_read_back=terms,
        app_keys=[None if s is None else len(s) for s in dumps],
        # the apps' and the clients' CPU over warm-up, window and drain
        child_cpu_s=dict(apps=[round(b - a, 3) for a, b in
                               zip(cpu0[:R], cpu1[:R])],
                         clients=round(cpu1[R] - cpu0[R], 3),
                         over_s=round(t_cpu1 - t_cpu0, 3)))
    for m in notes:
        say(m)
    return res
