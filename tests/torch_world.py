"""Real multi-process worlds of the port for the CPU tests: n processes
with the ``TPUJOB_*`` environment of one job, on a coordinator port
chosen here.

The port is drawn below the host's ephemeral range.  The kernel hands
ports of that range to every ``bind(0)`` and ``connect()`` on the host,
and the tests that run beside a world (other pytest workers' HTTP
servers and clients, their own worlds) make thousands of them: a port
taken from it and released before rank 0's store binds it could be
handed to another socket in between.  Below the range nothing is handed
out; only another explicit choice can collide, and rank 0 then reports
the address in use: that world, and only that one, is started again on
a new port.
"""

import os
import random
import socket
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: where a world's coordinator port is drawn from when the host does not
#: say where its ephemeral range starts
_EPHEMERAL_START = 32768
_LOWEST_PORT = 20000
#: rank 0's store says so when its port was taken
_IN_USE = ("EADDRINUSE", "address already in use")


def _ephemeral_start() -> int:
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return _EPHEMERAL_START


def free_port() -> int:
    """A port below the ephemeral range that nothing listens on now."""

    top = _ephemeral_start()
    rng = random.SystemRandom()
    while True:
        port = rng.randrange(_LOWEST_PORT, top)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port


def rank_env(rank: int, n: int, port: int, extra=None):
    env = dict(os.environ)
    for k in [k for k in env if k.startswith(("TPUJOB_", "MEGASCALE_", "TPU_WORKER"))]:
        env.pop(k)
    env.update({"TPUJOB_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                "TPUJOB_NUM_PROCESSES": str(n), "TPUJOB_PROCESS_ID": str(rank),
                "TPUJOB_REPLICA_TYPE": "worker", "TPUJOB_REPLICA_INDEX": str(rank),
                "TPUJOB_NAME": "port-world", "OMP_NUM_THREADS": "1",
                "PYTHONPATH": os.pathsep.join([ROOT, os.path.join(ROOT, "tests")]),
                "TPUJOB_NO_SUITE_RECORD": "1"})
    env.update((extra or {}).get(rank, {}))
    return env


class World:
    """``argv`` started as ranks 0..n-1 of one world; :meth:`wait`
    returns their stdouts (the caller can work while they run)."""

    def __init__(self, n: int, argv, extra=None, timeout=240):
        self.n, self.argv, self.extra, self.timeout = n, argv, extra, timeout
        self._start()

    def _start(self) -> None:
        port = free_port()
        self.procs = [subprocess.Popen(self.argv, cwd=ROOT,
                                       env=rank_env(r, self.n, port, self.extra),
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
                      for r in range(self.n)]

    def _collect(self):
        """(rank 0 lost its port, the outputs) of this start."""

        outs = []
        try:
            for r, p in enumerate(self.procs):
                outs.append(p.communicate(timeout=self.timeout)[0])
                if r == 0 and p.returncode != 0 and any(w in outs[0] for w in _IN_USE):
                    return True, outs
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, out) in enumerate(zip(self.procs, outs)):
            assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-4000:]}"
        return False, outs

    def wait(self, attempts: int = 3):
        for attempt in range(attempts):
            lost, outs = self._collect()
            if not lost:
                return outs
            if attempt + 1 < attempts:
                self._start()
        raise AssertionError(f"rank 0's coordinator port was taken {attempts} times:\n"
                             f"{outs[0][-2000:]}")


def run_world(n: int, argv, extra=None, timeout=240):
    """Run ``argv`` as ranks 0..n-1 of one world; returns their stdouts."""

    return World(n, argv, extra, timeout).wait()
