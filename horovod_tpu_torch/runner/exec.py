"""Process fan-out: local subprocess and ssh remote execution.

Reference: horovod/runner/util/remote.py + common/util/safe_shell_exec.py —
per-slot ssh commands with pty capture, exit-code monitoring threads, and
index-tagged output streaming (gloo_run.py:242-287).

Port of the JAX package's ``runner/exec.py``: one ``WorkerProcess`` per slot
(local, or one ssh command per slot on a remote host).
"""

import os
import shlex
import subprocess
import sys
import threading

from horovod_tpu_torch.common import logging as hvd_logging


def _stream(proc, tag, out, sink=None, prefix_timestamp=False):
    for line in iter(proc.stdout.readline, b""):
        text = line.decode(errors="replace")
        if prefix_timestamp:
            import datetime
            text = f"{datetime.datetime.now().isoformat(sep=' ')} {text}"
        out.write(f"[{tag}]<stdout> {text}")
        out.flush()
        if sink is not None:
            sink.write(text)
            sink.flush()
    # The reader owns the sink: close only after the pipe is fully drained,
    # so a slow drain can never race a closed file.
    if sink is not None:
        sink.close()


def build_launch_command(hostname, command, env, local, ssh_port=None,
                         ssh_identity_file=None):
    """Returns ``(argv, run_env, secret_env)``. Secrets must NEVER ride the
    remote argv — /proc/*/cmdline is world-readable on the worker host
    (the reference likewise keeps its per-job key off the command line:
    runner/common/util/secret.py travels through the task-service
    channel) — so env vars whose name contains SECRET are shipped over ssh
    stdin (``read -r`` before exec) instead of inline ``env`` assignments."""
    if local:
        return command, {**os.environ, **env}, {}
    ssh = ["ssh", "-o", "StrictHostKeyChecking=no"]
    if ssh_port:
        ssh += ["-p", str(ssh_port)]
    if ssh_identity_file:
        ssh += ["-i", ssh_identity_file]
    secret_env = {k: v for k, v in env.items() if "SECRET" in k}
    plain = {k: v for k, v in env.items() if "SECRET" not in k}
    exports = " ".join(f"{k}={shlex.quote(v)}" for k, v in plain.items())
    reads = "".join(f"read -r {k} && export {k} && "
                    for k in sorted(secret_env))
    full = ssh + [hostname,
                  f"cd {shlex.quote(os.getcwd())} && {reads}"
                  f"env {exports} "
                  + " ".join(shlex.quote(c) for c in command)]
    return full, os.environ.copy(), secret_env


class WorkerProcess:
    def __init__(self, hostname, command, env, tag, use_ssh=None,
                 ssh_port=None, ssh_identity_file=None, output_dir=None,
                 rank=None, prefix_timestamp=False):
        self.hostname = hostname
        self.tag = tag
        # --output-filename: mirror each worker's merged stdout/stderr to
        # <dir>/rank.<NN>/stdout (reference: launch.py:332 + gloo_run's
        # per-rank capture files).
        self._sink = None
        if output_dir:
            sub = os.path.join(output_dir,
                               f"rank.{rank:02d}" if rank is not None
                               else f"host.{hostname}")
            os.makedirs(sub, exist_ok=True)
            self._sink = open(os.path.join(sub, "stdout"), "a")
        # Any 127.0.0.0/8 address is this machine (loopback aliases let tests
        # model N distinct "hosts" locally, like the reference's
        # localhost-based integration tier).
        local = (hostname in ("localhost", "::1", os.uname().nodename)
                 or hostname.startswith("127.")) \
            if use_ssh is None else not use_ssh
        full, run_env, secret_env = build_launch_command(
            hostname, command, env, local, ssh_port, ssh_identity_file)
        hvd_logging.debug("launching worker %s: %s", tag, full)
        self.proc = subprocess.Popen(
            full, env=run_env,
            stdin=subprocess.PIPE if secret_env else None,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if secret_env:
            for k in sorted(secret_env):
                self.proc.stdin.write(secret_env[k].encode() + b"\n")
            self.proc.stdin.close()
        self._thread = threading.Thread(
            target=_stream, args=(self.proc, tag, sys.stdout, self._sink,
                                  prefix_timestamp), daemon=True)
        self._thread.start()

    def wait(self, timeout=None):
        rc = self.proc.wait(timeout)
        self._thread.join(timeout=30)
        return rc

    def terminate(self):
        """Stop the worker and reap it; returns only once the process is
        gone, so callers may safely reset shared state afterwards."""
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(5)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


def wait_for_any_failure_or_all_success(workers):
    """Monitor workers; on any nonzero exit terminate the rest
    (reference: gloo_run.py:277-287 exit-code monitoring). Returns the
    nonzero exit codes by tag, the first to fail first."""
    codes = {}
    codes_lock = threading.Lock()
    threads = []

    def watch(w):
        rc = w.wait()
        with codes_lock:
            codes[w.tag] = rc

    for w in workers:
        t = threading.Thread(target=watch, args=(w,), daemon=True)
        t.start()
        threads.append(t)
    while threads:
        for t in list(threads):
            t.join(timeout=0.2)
            if not t.is_alive():
                threads.remove(t)
        with codes_lock:
            snapshot = dict(codes)
        failed = {k: v for k, v in snapshot.items() if v not in (None, 0)}
        if failed:
            for w in workers:
                if w.tag not in snapshot:
                    w.terminate()
            for t in threads:
                t.join()
            return failed
    with codes_lock:
        return {k: v for k, v in codes.items() if v != 0}
