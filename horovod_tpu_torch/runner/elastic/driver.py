"""Elastic driver: membership and the workers' lifecycle.

Port of the JAX package's ``runner/elastic/driver.py`` (reference:
horovod/runner/elastic/driver.py: ElasticDriver:69, the discovery thread
:188-208, rank-preserving reassignment :240-283, respawn :284-302, exit
handling and blacklist :304+). Workers learn of a membership change by
polling a version counter in the launcher's KV store; survivors keep their
process and re-initialize in place (``elastic/state.py::_reset``), removed
workers are terminated, and only new ones are started.

Where the JAX driver keeps one process per host, this one keeps one per
slot, as the port's launcher does: a slot is (host, local rank), and a
survivor keeps its local rank, so its device, across versions. Each version
``v`` publishes, in this order: one assignment row per slot
(``assignment/{v}/{host}/{local_rank}``: rank, sizes and the coordinator
store's address and port, which rank 0 serves), the slot count
(``elastic/nslots/{v}``), the update kind (``add`` when a slot was added,
else ``removal``: removal-only versions let survivors keep their
uncommitted state), whether a slot of the last membership is gone
(``elastic/removed/{v}``: the workers' watchdog aborts their collectives),
then the version (``elastic/version``). A host whose slot count changed
keeps its surviving slots' processes. A version that removed a slot (a
crashed one included) appends a disruption marker to
``driver_events.jsonl`` in the flight directory (``flight.driver_mark``):
``flight.analyze`` ties the workers' dumps to the membership change that
caused them.

Chaos (``--chaos-plan``): the driver arms the plan in its own process under
the ``driver`` role; each discovery poll is one call of the
``driver.discovery`` site, where a ``host_remove`` spec drops its victim
for its window (a simulated preemption, recovered through the same
reassignment as a real removal). The KV store is sharded as the static
launcher's is (``control_plane.kv_shard_count`` of the largest world the
job may reach), and every worker gets the shard ports.

The autopilot's driver arm (``autopilot/remediate.py::DriverArm``, over
the launcher's KV and this driver's ``HostManager``): every discovery
poll consumes the controller's removal requests, re-checks the floor
(``max(HOROVOD_AUTOPILOT_MIN_WORLD, --min-np)``) and the rate
(``HOROVOD_AUTOPILOT_MAX_REMOVALS``) against the driver's own view, and
blacklists an accepted host through the cooldown path, as a crashed host
is; the host leaves that round's assignment at once and the survivors
re-rendezvous.
"""

import json
import os
import threading
import time

from horovod_tpu_torch.chaos import injector as _chaos
from horovod_tpu_torch.common import logging as hvd_logging
from horovod_tpu_torch.common.config import Config
from horovod_tpu_torch.runner.elastic.discovery import HostManager
from horovod_tpu_torch.runner.hosts import HostInfo, get_host_assignments

DISCOVER_INTERVAL_SECS = 1.0


class ElasticDriver:
    def __init__(self, discovery, min_np, max_np=None, reset_limit=None,
                 spawn_fn=None, shutdown_fn=None, cooldown_range=None,
                 remediation_fn=None):
        """``spawn_fn(assignment, version)`` starts the workers of a new
        assignment; ``shutdown_fn(reason)`` stops them. Injected for tests,
        as the reference's tests drive ``_update_host_assignments``
        (reference: test_elastic_driver.py:46-509). ``cooldown_range``:
        "base,cap" seconds of a failed host's cooldown.
        ``remediation_fn(hosts)``: the autopilot's driver arm
        (``DriverArm.poll``), called on every discovery poll with the
        discovered hosts; the hosts it returns leave this round's
        assignment (the cooldown keeps them out of later ones)."""
        self._host_manager = HostManager(discovery, cooldown_range)
        self._remediation_fn = remediation_fn
        self._min_np = min_np
        self._max_np = max_np
        self._reset_limit = reset_limit
        self._spawn_fn = spawn_fn or (lambda assignment, version: None)
        self._shutdown_fn = shutdown_fn or (lambda reason: None)

        self._assignment = []          # list[SlotInfo]
        self._last_hosts = None        # last discovered {host: slots}
        self._host_order = []          # rank-ordered hostnames
        self._disrupted = {}           # version -> a slot of the last one gone
        self._version = 0
        self._reset_count = 0
        self._shutdown = threading.Event()
        self._assignment_cv = threading.Condition()
        self._thread = None

    # --- lifecycle -----------------------------------------------------
    def start(self):
        self._thread = threading.Thread(target=self._discover_loop,
                                        daemon=True)
        self._thread.start()

    def stop(self, reason="driver stop"):
        self._shutdown.set()
        # stop() may run on the discovery thread itself (the reset limit
        # firing inside _discover_loop): never join ourselves.
        if self._thread and self._thread is not threading.current_thread():
            self._thread.join(timeout=5)
        self._shutdown_fn(reason)

    def wait_for_available_slots(self, min_np, timeout=600):
        """Block until discovery finds >= min_np slots
        (reference: driver.py:153 wait_for_available_slots)."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            hosts = self._host_manager.current_hosts()
            if sum(hosts.values()) >= min_np:
                return hosts
            if self._shutdown.is_set():
                raise RuntimeError("driver shut down while waiting for slots")
            time.sleep(0.2)
        raise TimeoutError(
            f"fewer than min_np={min_np} slots available after {timeout}s")

    # --- membership ----------------------------------------------------
    def _discover_loop(self):
        while not self._shutdown.is_set():
            try:
                hosts = self._host_manager.current_hosts()
                if _chaos.armed:
                    hosts = _chaos.filter_hosts("driver.discovery", hosts)
                if self._remediation_fn is not None:
                    removed = self._remediation_fn(hosts) or ()
                    if removed:
                        hosts = {h: s for h, s in hosts.items()
                                 if h not in removed}
                self._maybe_update(hosts)
            except Exception as e:  # noqa: BLE001 — a discovery hiccup
                if self._shutdown.is_set():
                    break  # stop() already ran (the reset limit)
                hvd_logging.warning("discovery error: %s", e)
            self._shutdown.wait(DISCOVER_INTERVAL_SECS)

    def _maybe_update(self, hosts):
        # Against the last DISCOVERED hosts, slot counts included: comparing
        # against the assignment would churn whenever max_np clamps it.
        with self._assignment_cv:
            have_assignment = bool(self._assignment)
        if hosts == self._last_hosts and have_assignment:
            return
        if sum(hosts.values()) < self._min_np:
            hvd_logging.warning(
                "available slots %s below min_np %d; waiting",
                hosts, self._min_np)
            return
        self.update_host_assignments(hosts)

    def update_host_assignments(self, hosts):
        """Recompute the slots, keeping the rank order of surviving hosts
        so their state stays rank-stable (reference: driver.py:240-283)."""
        self._last_hosts = dict(hosts)
        with self._assignment_cv:
            surviving = [h for h in self._host_order if h in hosts]
            new = [h for h in hosts if h not in surviving]
            order = surviving + new
            np_target = sum(hosts.values())
            if self._max_np:
                np_target = min(np_target, self._max_np)
            assignment = get_host_assignments(
                [HostInfo(h, hosts[h]) for h in order], np_target)
            # Disruption: a slot of the last membership is gone, so the
            # survivors' collectives in flight can never complete (their
            # watchdog aborts them). Slots only added leave them
            # completable. Decided against the last assignment, not the
            # live worker table: a crashed worker leaves that table before
            # the respawn, which would hide its own removal.
            kept = {slot_key(s) for s in assignment}
            disrupted = any(slot_key(s) not in kept
                            for s in self._assignment)
            self._host_order = order
            self._assignment = assignment
            self._version += 1
            version = self._version
            self._disrupted[version] = disrupted
            self._disrupted.pop(version - 3, None)
            self._assignment_cv.notify_all()
        hvd_logging.info("new assignment v%d over hosts %s", version, order)
        self._reset_count += 1
        if self._reset_limit is not None \
                and self._reset_count > self._reset_limit:
            self.stop(f"reset limit {self._reset_limit} exceeded")
            raise RuntimeError(
                f"elastic reset limit {self._reset_limit} exceeded")
        self._spawn_fn(assignment, version)

    def version_disrupted(self, version):
        """Whether ``version`` removed a slot of the membership before it.
        Unknown (collected) versions count as disruptive: a worker that far
        behind is stuck by construction."""
        with self._assignment_cv:
            return self._disrupted.get(version, True)

    # --- worker results ------------------------------------------------
    def record_worker_exit(self, host, exit_code):
        """reference: driver.py:304+ _handle_worker_exit — a failed host
        cools down and the assignment is recomputed without it."""
        if exit_code != 0:
            self._host_manager.record_failure(host)
            hosts = self._host_manager.current_hosts()
            if sum(hosts.values()) >= self._min_np:
                self.update_host_assignments(hosts)


def slot_key(slot):
    """A slot's identity across versions: (host, local rank)."""
    return slot.hostname, slot.local_rank


def publish_assignment(kv, assignment, version, survivors, disrupted,
                       coordinator_addr, coordinator_port):
    """Publish membership ``version`` in the KV store, the version last:
    each slot's row, the slot count, the update kind (``add`` when a slot
    is not among ``survivors``, else ``removal``) and whether a slot of the
    last membership is gone (``disrupted``). Returns False, with the
    version unpublished, when a worker has finished the job meanwhile: it
    must not be counted into a membership it will never join."""
    by_slot = {slot_key(s): s for s in assignment}
    # Rows before the version: survivors re-initialize the moment they see
    # it.
    for (host, local_rank), s in by_slot.items():
        kv.put("assignment", f"{version}/{host}/{local_rank}", json.dumps({
            "rank": s.rank, "size": s.size, "local_size": s.local_size,
            "cross_rank": s.cross_rank, "cross_size": s.cross_size,
            "coordinator_addr": coordinator_addr,
            "coordinator_port": coordinator_port}).encode())
    if kv.get("elastic", "finished"):
        return False
    kind = b"add" if any(k not in survivors for k in by_slot) else b"removal"
    for name, value in (("nslots", str(len(by_slot)).encode()),
                        ("update_kind", kind),
                        ("removed", b"1" if disrupted else b"0")):
        kv.put("elastic", f"{name}/{version}", value)
        kv.delete("elastic", f"{name}/{version - 2}")
    kv.put("elastic", "nslots", str(len(by_slot)).encode())
    kv.put("elastic", "version", str(version).encode())
    return True


def run_elastic_driver(args, kv_preload=None, harvest=None, extra_env=None):
    """``hvdrun-torch --min-np ... --host-discovery-script ...``: start the
    KV store and the discovery thread, (re)spawn workers per version, and
    return the job's exit code once every worker has exited (the workers of
    the last membership are reaped on every exit path).

    ``kv_preload`` seeds the KV store before any worker starts (the pickled
    function of ``run_elastic()``); ``harvest(kv)`` runs after a clean
    finish to collect the workers' results."""
    import socket

    from horovod_tpu_torch.runner.elastic.discovery import (
        FixedHosts, HostDiscoveryScript)
    from horovod_tpu_torch.runner.exec import WorkerProcess, is_local
    from horovod_tpu_torch.runner.hosts import parse_hosts
    from horovod_tpu_torch.runner.http_kv import KVStoreServer
    from horovod_tpu_torch.runner.launch import _free_port, build_worker_env
    from horovod_tpu_torch.runner.secret import SECRET_ENV, make_secret_key

    if args.host_discovery_script:
        discovery = HostDiscoveryScript(args.host_discovery_script,
                                        args.slots_per_host or 1)
    elif args.hosts:
        discovery = FixedHosts(parse_hosts(args.hosts))
    else:
        raise ValueError("elastic mode needs --host-discovery-script or -H")
    os.environ.setdefault(SECRET_ENV, make_secret_key())
    # The store's address as the workers reach it: loopback when every host
    # discovered at the start is this machine.
    local = all(is_local(h) for h in discovery.find_available_hosts_and_slots())
    kv_addr = "127.0.0.1" if local else socket.gethostname()

    from horovod_tpu_torch.common import control_plane as _cp
    from horovod_tpu_torch.common.config import _env_int
    from horovod_tpu_torch.runner import config_parser
    flag_env = config_parser.set_env_from_args(dict(os.environ), args)
    # Sharded by the largest world the job may reach: a membership change
    # must not restart listeners.
    kv = KVStoreServer(
        shards=_cp.kv_shard_count(args.max_np or args.np or args.min_np or 1,
                                  env=flag_env),
        shard_port_base=_env_int("HOROVOD_KV_SHARD_PORT_BASE", 0, flag_env))
    kv_port = kv.start()
    for (scope, key), value in (kv_preload or {}).items():
        kv.put(scope, key, value)
    state = {"workers": {}, "done": threading.Event(), "rc": 0, "version": 0,
             "completing": False, "lock": threading.Lock(),
             "spawn_lock": threading.Lock()}

    def spawn(assignment, version):
        """Differential (re)spawn: survivors re-initialize in place when
        they see the version, removed slots' workers are terminated, new
        slots' workers are started (reference: driver.py:284-302)."""
        # Whole (re)spawns are serialized: the discovery thread and a
        # worker's exit (record_worker_exit on a _watch thread) can race,
        # and an older version's rows landing after a newer one's would
        # roll the membership back.
        with state["spawn_lock"]:
            with state["lock"]:
                if version < state["version"]:
                    return
                completing = state["completing"]
            # A worker that finished cleanly means the job is winding down:
            # a new membership would wait forever on the exited ranks.
            if completing or kv.get("elastic", "finished"):
                hvd_logging.info("dropping spawn v%d: job is completing",
                                 version)
                return
            with state["lock"]:
                state["version"] = version
            _spawn_locked(assignment, version)

    def _spawn_locked(assignment, version):
        coordinator_port = _free_port()
        by_slot = {slot_key(s): s for s in assignment}
        with state["lock"]:
            # Popped first, so their _watch threads see them as stale and
            # do not report the termination as a host failure.
            gone = [k for k in state["workers"] if k not in by_slot]
            removed = [state["workers"].pop(k) for k in gone]
            survivors = set(state["workers"])
        for w in removed:
            w.terminate()    # reaped before the KV moves on
        # Version-scoped rows of the previous and this version are kept: a
        # worker that read the previous version just before this bump can
        # still fetch its row.
        keep = (f"{version}/", f"{version - 1}/")
        for scope in ("results", "assignment", "new_rank_ready"):
            kv.prune_scope(scope, keep)
        if driver.version_disrupted(version):
            # JAX's rule: every disruptive version is marked, a crash's too
            # (its worker left the table before this respawn, so ``gone``
            # names only the hosts this version terminates).
            from horovod_tpu_torch.flight import recorder as _flight
            _flight.driver_mark(version, sorted({k[0] for k in gone}),
                                sorted({s.hostname for s in assignment}))
        first = assignment[0].hostname
        coordinator_addr = kv_addr if is_local(first) else first
        if not publish_assignment(kv, assignment, version, survivors,
                                  driver.version_disrupted(version),
                                  coordinator_addr, coordinator_port):
            hvd_logging.info("aborting spawn v%d: job finished", version)
            return
        for key, s in by_slot.items():
            if key in survivors:
                continue    # re-initializes in place on the bump
            env = build_worker_env(
                {**(extra_env or {}), "HOROVOD_ELASTIC": "1"}, s,
                coordinator_addr, coordinator_port, kv_port, args,
                kv_shard_ports=kv.shard_ports)
            env.update({"HOROVOD_KV_ADDR": kv_addr,
                        "HOROVOD_HOST_KEY": s.hostname,
                        # Results are keyed by the version a worker last
                        # initialized under (runner/task.py).
                        "HOROVOD_ELASTIC_INIT_VERSION": str(version)})
            w = WorkerProcess(
                s.hostname, args.command, env,
                tag=f"{s.hostname}/{s.local_rank}@v{version}",
                ssh_port=args.ssh_port,
                ssh_identity_file=args.ssh_identity_file,
                output_dir=getattr(args, "output_filename", None),
                rank=s.rank, prefix_timestamp=getattr(
                    args, "prefix_output_with_timestamp", False))
            with state["lock"]:
                state["workers"][key] = w
            threading.Thread(target=_watch, args=(key, w),
                             daemon=True).start()

    def _watch(key, worker):
        rc = worker.wait()
        with state["lock"]:
            stale = state["workers"].get(key) is not worker
            if not stale:
                state["workers"].pop(key)
                if rc == 0:
                    # A clean finish: no more rebalancing (peers that
                    # exited can never join a new membership).
                    state["completing"] = True
        if stale:
            return    # removed by a newer assignment; terminated on purpose
        driver.record_worker_exit(key[0], rc)
        # After record_worker_exit: a crash may just have respawned a
        # replacement, and the job is not over then.
        with state["lock"]:
            remaining = bool(state["workers"])
        if not remaining:
            state["rc"] = max(abs(rc or 0), state["rc"])
            state["done"].set()

    def shutdown(reason):
        with state["lock"]:
            workers = list(state["workers"].values())
        for w in workers:
            w.terminate()
        if reason != "driver stop":
            state["rc"] = max(state["rc"], 1)
        state["done"].set()

    cooldown = args.blacklist_cooldown_range
    # The autopilot's driver arm: present whether or not the workers run
    # the controller (requests appear only when they do).
    from horovod_tpu_torch.autopilot import remediate as _ap_remediate
    arm = []
    driver = ElasticDriver(
        discovery, args.min_np or 1, args.max_np, args.reset_limit,
        spawn_fn=spawn, shutdown_fn=shutdown,
        cooldown_range=f"{cooldown[0]},{cooldown[1]}" if cooldown else None,
        remediation_fn=lambda hosts: arm[0].poll(hosts) if arm else ())
    arm.append(_ap_remediate.DriverArm(
        kv, driver._host_manager,
        min_world=max(_env_int("HOROVOD_AUTOPILOT_MIN_WORLD", 0, flag_env),
                      args.min_np or 1),
        max_removals=_env_int("HOROVOD_AUTOPILOT_MAX_REMOVALS", 1,
                              flag_env)))
    from horovod_tpu_torch.common.config import _env_bool
    from horovod_tpu_torch.flight import recorder as _flight
    # This process's dumps and markers are the driver's; the flight switch
    # is re-read, since the launcher set the env after the import.
    _flight.set_role("driver")
    _flight.set_enabled(_env_bool("HOROVOD_FLIGHT_RECORDER", True))
    # The driver's own copy of the plan (host_remove rides its discovery
    # polls; the workers arm theirs from their env at init), from the
    # flags as the workers get them.
    _chaos.set_role("driver")
    chaos_before = _chaos.plan()
    _chaos.install_from_env(flag_env)
    driver.start()
    try:
        driver.wait_for_available_slots(
            args.min_np or 1, timeout=args.elastic_timeout
            or Config.from_env().elastic_timeout or args.start_timeout)
        state["done"].wait()
        # Discovery stops before the harvest: a membership change now would
        # prune the results being read.
        driver.stop()
        if state["rc"] == 0 and harvest is not None:
            harvest(kv)
        return state["rc"]
    finally:
        driver.stop()    # terminates and reaps whatever still runs
        kv.stop()
        _flight.set_role("worker")
        # An in-process driver (run_elastic) leaves the process as it was:
        # a plan it armed goes, and the role reverts.
        if _chaos.plan() is not chaos_before:
            _chaos.uninstall()
        _chaos.set_role("worker")
