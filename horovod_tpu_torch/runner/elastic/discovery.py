"""Elastic host discovery.

Port of the JAX package's ``runner/elastic/discovery.py`` (reference:
horovod/runner/elastic/discovery.py — the ``HostDiscovery`` interface,
``HostDiscoveryScript`` (runs a user script printing ``hostname:slots``
lines, :146+), and ``HostManager`` with per-host blacklist and cooldown
(:33-110) so a flapping host is not reused at once). Unchanged in meaning:
discovery and failures are per host; the driver assigns per slot.
"""

import subprocess
import threading
import time

from horovod_tpu_torch.common import logging as hvd_logging
from horovod_tpu_torch.common.config import Config
from horovod_tpu_torch.runner.hosts import HostInfo


class HostDiscovery:
    def find_available_hosts_and_slots(self):
        """Return {hostname: slots}."""
        raise NotImplementedError


class FixedHosts(HostDiscovery):
    def __init__(self, hosts):
        self._hosts = {h.hostname: h.slots for h in hosts}

    def find_available_hosts_and_slots(self):
        return dict(self._hosts)


class HostDiscoveryScript(HostDiscovery):
    """reference: discovery.py HostDiscoveryScript — executes the script,
    parses ``host`` or ``host:slots`` lines."""

    def __init__(self, discovery_script, default_slots=1):
        self._script = discovery_script
        self._default_slots = default_slots

    def find_available_hosts_and_slots(self):
        out = subprocess.check_output(self._script, shell=True,
                                      timeout=60).decode()
        hosts = {}
        for line in out.splitlines():
            line = line.strip()
            if not line:
                continue
            hi = HostInfo.from_string(line)
            hosts[hi.hostname] = hi.slots if ":" in line \
                else self._default_slots
        return hosts


class HostState:
    """Per-host cooldown (reference: discovery.py:33-110 HostState): each
    failure cools the host down for ``base * 2**(n-1)``
    seconds, at most ``cap`` (``--blacklist-cooldown-range base cap``,
    HOROVOD_BLACKLIST_COOLDOWN_RANGE; ``cooldown_range`` "base,cap" takes
    its place)."""

    COOLDOWN_BASE = 10.0
    COOLDOWN_MAX = 600.0

    def __init__(self, cooldown_range=None):
        self.failures = 0
        self.cooldown_until = 0.0
        rng = cooldown_range if cooldown_range is not None \
            else Config.from_env().blacklist_cooldown_range
        if rng:
            try:
                base, cap = (float(x) for x in rng.split(","))
                self.COOLDOWN_BASE, self.COOLDOWN_MAX = base, cap
            except ValueError:
                pass

    def record_failure(self):
        self.failures += 1
        cooldown = min(self.COOLDOWN_BASE * (2 ** (self.failures - 1)),
                       self.COOLDOWN_MAX)
        self.cooldown_until = time.time() + cooldown

    def usable(self):
        return time.time() >= self.cooldown_until


class HostManager:
    """Tracks the discovered hosts and their health; computes the usable
    set (reference: driver.py + discovery.py host bookkeeping)."""

    def __init__(self, discovery, cooldown_range=None):
        self._discovery = discovery
        self._cooldown_range = cooldown_range
        self._states = {}
        self._lock = threading.Lock()

    def state(self, host):
        with self._lock:
            if host not in self._states:
                self._states[host] = HostState(self._cooldown_range)
            return self._states[host]

    def record_failure(self, host):
        hvd_logging.warning("host %s failed; cooling down", host)
        self.state(host).record_failure()

    def current_hosts(self):
        available = self._discovery.find_available_hosts_and_slots()
        return {h: s for h, s in available.items()
                if self.state(h).usable()}
