"""Full-stack APUS end-to-end on the port: an UNMODIFIED TCP key-value
server made fault-tolerant by LD_PRELOAD interposition and the port's
``ClusterDriver`` (``device="cpu"`` here; the card in ``chip_smoke.py``).

``tests/test_e2e_apus.py``'s three tests on the port: three toyserver
processes run under ``LD_PRELOAD=interpose.so`` with ``RP_PROXY_SOCK``
pointing at their replica's driver socket; a real TCP client talks to
the leader's app; followers' apps receive the identical byte stream by
loopback replay. The apps listen on free ephemeral ports (the JAX
package's e2e tests hold fixed ones)."""

import os
import socket
import subprocess
import time

import pytest
import torch

from rdma_paxos_tpu_torch.config import LogConfig, TimeoutConfig
from rdma_paxos_tpu_torch.runtime.driver import ClusterDriver

torch.set_num_threads(1)

NATIVE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")

CFG = LogConfig(n_slots=256, slot_bytes=128, window_slots=32, batch_slots=16)


@pytest.fixture(scope="module", autouse=True)
def build_native():
    subprocess.run(["make", "-C", NATIVE], check=True, capture_output=True)


def free_ports(n: int):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


class Client:
    def __init__(self, port):
        self.s = socket.create_connection(("127.0.0.1", port), timeout=10)
        self.f = self.s.makefile("rb")

    def cmd(self, line: str) -> bytes:
        self.s.sendall(line.encode() + b"\n")
        return self.f.readline().strip()

    def close(self):
        # the reader holds the socket open too: close both, or the app
        # never sees EOF (and never reports the CLOSE)
        for h in (self.f, self.s):
            try:
                h.close()
            except OSError:
                pass


@pytest.fixture()
def stack(tmp_path):
    apps, driver = [], None
    ports = free_ports(3)
    try:
        driver = ClusterDriver(
            CFG, 3, workdir=str(tmp_path), app_ports=ports,
            timeout_cfg=TimeoutConfig(elec_timeout_low=0.3,
                                      elec_timeout_high=0.6),
            device="cpu")
        for r, port in enumerate(ports):
            env = dict(os.environ)
            env["LD_PRELOAD"] = os.path.join(NATIVE, "interpose.so")
            env["RP_PROXY_SOCK"] = os.path.join(str(tmp_path),
                                                f"proxy{r}.sock")
            apps.append(subprocess.Popen(
                [os.path.join(NATIVE, "toyserver"), str(port)], env=env,
                stderr=subprocess.DEVNULL))
        time.sleep(0.3)            # let apps bind
        driver.run(period=0.002)
        deadline = time.time() + 60
        while driver.leader() < 0 and time.time() < deadline:
            time.sleep(0.05)
        assert driver.leader() >= 0, "no leader elected"
        yield driver, ports
    finally:
        if driver is not None:
            driver.stop()
        for a in apps:
            a.kill()
            a.wait()


def wait_kv(port, key, want, timeout=15.0):
    deadline = time.time() + timeout
    last = None
    while time.time() < deadline:
        try:
            c = Client(port)
            last = c.cmd(f"GET {key}")
            c.close()
            if last == want:
                return last
        except OSError:
            pass
        time.sleep(0.1)
    return last


def test_replicated_set_reaches_followers(stack):
    driver, ports = stack
    lead = driver.leader()
    c = Client(ports[lead])
    assert c.cmd("SET alpha 1") == b"+OK"
    assert c.cmd("SET beta two") == b"+OK"
    assert c.cmd("GET alpha") == b"1"
    c.close()
    for r in range(3):
        if r == lead:
            continue
        assert wait_kv(ports[r], "alpha", b"1") == b"1", f"replica {r}"
        assert wait_kv(ports[r], "beta", b"two") == b"two", f"replica {r}"
    assert driver.loop_error is None


def test_failover_preserves_state_and_serves_writes(stack):
    driver, ports = stack
    lead = driver.leader()
    c = Client(ports[lead])
    assert c.cmd("SET durable yes") == b"+OK"
    c.close()
    for r in range(3):
        assert wait_kv(ports[r], "durable", b"yes") == b"yes"

    # crash the leader replica (driver-side partition = dead consensus node)
    driver.cluster.partition([[lead], [r for r in range(3) if r != lead]])
    deadline = time.time() + 60
    while time.time() < deadline:
        nl = driver.leader()
        if nl >= 0 and nl != lead:
            break
        time.sleep(0.05)
    new_lead = driver.leader()
    assert new_lead >= 0 and new_lead != lead, "failover did not happen"

    # the new leader's app already holds the replicated state…
    c = Client(ports[new_lead])
    assert c.cmd("GET durable") == b"yes"
    # …and serves new writes that replicate to the remaining follower
    assert c.cmd("SET after failover-ok") == b"+OK"
    c.close()
    other = next(r for r in range(3) if r not in (lead, new_lead))
    assert wait_kv(ports[other], "after", b"failover-ok") == b"failover-ok"


def test_events_persisted_to_stable_store(stack):
    driver, ports = stack
    lead = driver.leader()
    c = Client(ports[lead])
    assert c.cmd("SET persisted 42") == b"+OK"
    c.close()
    # every replica persists the CONNECT/SEND/CLOSE stream natively
    deadline = time.time() + 15
    while time.time() < deadline and not all(
            len(rt.store) >= 3 for rt in driver.runtimes):
        time.sleep(0.1)
    for rt in driver.runtimes:
        assert rt.store is not None and len(rt.store) >= 3
        kinds = [rt.store.read(i)[0] for i in range(len(rt.store))]
        assert kinds[:3] == [2, 3, 4], (rt.idx, kinds)
