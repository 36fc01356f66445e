"""``python -m horovod_tpu_torch.telemetry.top`` — live cluster terminal view.

Port of the JAX package's ``telemetry/top.py``: the same frames and gates.

The operator's first stop when a job looks wedged: one screen answering
"is this job healthy, and which slice/rank is the problem?" from the
job view the telemetry plane already maintains — no per-rank scraping.

Two sources, in precedence order:

- ``--url http://host:port`` — a metrics endpoint (any rank's); reads
  ``GET /cluster/health`` + ``/cluster/steps``.
- ``--kv host:port`` — the launcher HTTP-KV store directly (works even
  when no metrics endpoint was armed); reads the ``telemetry/job`` key.

``--once`` prints a single frame and exits 0 when every rank is healthy,
1 otherwise (scriptable health gate); the default loop redraws every
``--interval`` seconds until Ctrl-C.
"""

import argparse
import json
import sys
import time

_STATE_GLYPH = {
    "healthy": ".", "straggling": "~", "desynced": "#",
    "stalled": "!", "dead": "X",
}


def _fetch_url(base):
    from urllib import request as urlrequest
    with urlrequest.urlopen(base.rstrip("/") + "/cluster/health",
                            timeout=5) as r:
        return json.loads(r.read())


def _fetch_kv(addr_port):
    from horovod_tpu_torch.runner.http_kv import KVStoreClient
    addr, port = addr_port.rsplit(":", 1)
    raw = KVStoreClient(addr, int(port), timeout=5).get("telemetry", "job")
    return json.loads(raw) if raw is not None else None


def _fetch_serving(base):
    from urllib import request as urlrequest
    with urlrequest.urlopen(base.rstrip("/") + "/serving/health",
                            timeout=5) as r:
        return json.loads(r.read())


def _age(now, t):
    return f"{now - t:5.1f}s" if t else "    ?"


def gate(view, now=None):
    """The ``--once`` exit gate: True iff the view exists, is FRESH, and
    every rank is healthy. Freshness matters as much as the states — a
    dead job stops publishing, leaving its last (often all-healthy) view
    in the KV; a gate that ignored age would green-light a crashed
    cluster. The bound is the view's own dead_after + one interval of
    publish slack."""
    if view is None:
        return False
    now = now if now is not None else time.time()
    t = view.get("t")
    dead_after = (view.get("thresholds") or {}).get("dead_after") \
        or 3.0 * view.get("interval_s", 2.0)
    if t is None or now - t > dead_after + view.get("interval_s", 2.0):
        return False
    health = view.get("health") or {}
    return bool(health) and all(s.get("state") == "healthy"
                                for s in health.values())


def serving_ready(snap):
    """The serving half of the readiness gate (``--once --serving``):
    True iff a serving engine answered AND it can absorb traffic — the
    admission queue is below its declared limit and the slot caches are
    live (a post-disruption engine whose caches are still stale must not
    take load-balancer traffic yet). Pure so tests drive it with
    synthetic frames."""
    if not snap or snap.get("error"):
        return False
    if snap.get("saturated"):
        return False
    return bool(snap.get("cache_valid", True))


def render_serving(snap):
    """One-line serving frame appended under the cluster view."""
    if not snap or snap.get("error"):
        return "serving: no engine answered"
    # Declared-SLO burn column (absent when no HOROVOD_SLO_* objective
    # is set): burn >= 1 means the error budget is being consumed at or
    # beyond its sustainable rate — flagged so the one-shot gate output
    # is greppable.
    slo = snap.get("slo") or {}
    burn = "".join(f"  burn[{obj}]={b:.2f}" + ("!" if b >= 1.0 else "")
                   for obj, b in sorted(slo.items()))
    return (f"serving: {snap.get('active', 0)}/{snap.get('slots', '?')} "
            f"slots  queue={snap.get('queue_depth', 0)}"
            + (f"/{snap['queue_limit']}" if snap.get("queue_limit") else "")
            + f"  served={snap.get('served', 0)}"
            f"  fill={snap.get('fill_ratio', 0.0):.2f}"
            + burn
            + ("  SATURATED" if snap.get("saturated") else "")
            + ("" if snap.get("cache_valid", True) else "  CACHE-STALE"))


def render(view, now=None):
    """One frame of the live view as a string (pure: tested directly)."""
    if view is None:
        return "no job view published yet (is the telemetry plane armed?)"
    now = now if now is not None else time.time()
    counts = view.get("counts", {})
    lines = []
    lines.append(
        f"job view g{view.get('gen')}  world={view.get('world')}  "
        f"slices={view.get('num_slices')}  leader=r{view.get('leader')}  "
        f"age={_age(now, view.get('t'))}")
    progress = view.get("progress") or {}
    if "median_step" in progress:
        lines.append(
            f"steps: median={progress['median_step']} "
            f"min={progress.get('min_step')} "
            f"max={progress.get('max_step')}")
    gp = view.get("goodput") or {}
    if gp.get("ratio") is not None:
        worst = None
        for r, d in (gp.get("ranks") or {}).items():
            ratio = (d or {}).get("ratio")
            if ratio is not None and (worst is None or ratio < worst[1]):
                worst = (r, ratio)
        lines.append(
            f"goodput: {gp['ratio']:.1%}"
            + (f"  worst=r{worst[0]} ({worst[1]:.1%})" if worst else ""))
    lines.append("health: " + "  ".join(
        f"{s}={counts.get(s, 0)}" for s in
        ("healthy", "straggling", "desynced", "stalled", "dead")))
    # Rank strip: one glyph per rank, grouped by slice.
    health = view.get("health") or {}
    slices = view.get("slices") or {}
    for sid in sorted(slices, key=int):
        meta = slices[sid] or {}
        members = meta.get("members") or []
        strip = "".join(_STATE_GLYPH.get(
            (health.get(str(r)) or {}).get("state", "dead"), "?")
            for r in members)
        lines.append(
            f"  slice {sid} [leader r{meta.get('leader')}, "
            f"{meta.get('digests', 0)}/{len(members)} digests, "
            f"age {_age(now, meta.get('t'))}]  {strip}")
    bad = {r: s for r, s in health.items()
           if s.get("state") != "healthy"}
    for r in sorted(bad, key=int)[:16]:
        s = bad[r]
        lines.append(
            f"  r{r}: {s['state']} ({s.get('why', '?')}"
            + (f", step {s.get('step')}" if s.get("step") is not None
               else "")
            + (f", age {s['age_s']}s" if s.get("age_s") is not None
               else "") + ")")
    events = (view.get("events") or [])[-6:]
    if events:
        lines.append("recent transitions:")
        for e in events:
            why = f"{e['why']}, " if e.get("why") else ""
            lines.append(
                f"  r{e.get('rank')} {e.get('from')}→{e.get('to')} "
                f"({why}g{e.get('gen')})")
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.telemetry.top",
        description="Live cluster health view from the telemetry plane.")
    p.add_argument("--url", help="a metrics endpoint base URL "
                                 "(http://host:port)")
    p.add_argument("--kv", help="the launcher KV store (host:port; "
                                "HOROVOD_KV_ADDR/PORT)")
    p.add_argument("--interval", type=float, default=2.0)
    p.add_argument("--once", action="store_true",
                   help="print one frame; exit 0 iff all ranks healthy")
    p.add_argument("--serving", action="store_true",
                   help="additionally account serving health (the "
                        "/serving/health frame of --url): the --once "
                        "gate then also requires an unsaturated engine "
                        "with live caches — the load-balancer readiness "
                        "probe. Requires --url.")
    args = p.parse_args(argv)
    if args.serving and not args.url:
        p.error("--serving reads /serving/health and needs --url")
    if not args.url and not args.kv:
        import os
        addr, port = os.environ.get("HOROVOD_KV_ADDR"), \
            os.environ.get("HOROVOD_KV_PORT")
        if addr and port:
            args.kv = f"{addr}:{port}"
        else:
            p.error("need --url or --kv (or HOROVOD_KV_ADDR/PORT)")

    def fetch():
        try:
            return _fetch_url(args.url) if args.url \
                else _fetch_kv(args.kv)
        except Exception as e:  # noqa: BLE001 — keep the view alive
            print(f"fetch failed: {e}", file=sys.stderr)
            return None

    def fetch_serving():
        if not args.serving:
            return None
        try:
            return _fetch_serving(args.url)
        except Exception as e:  # noqa: BLE001 — a dead engine = not ready
            print(f"serving fetch failed: {e}", file=sys.stderr)
            return None

    if args.once:
        view = fetch()
        print(render(view))
        ok = gate(view)
        if args.serving:
            snap = fetch_serving()
            print(render_serving(snap))
            ok = ok and serving_ready(snap)
        if not ok and view is not None \
                and all(s.get("state") == "healthy"
                        for s in (view.get("health") or {}).values()):
            print("gate: job view is STALE — the plane (or the whole "
                  "job) stopped publishing", file=sys.stderr)
        return 0 if ok else 1
    try:
        while True:
            frame = render(fetch())
            if args.serving:
                frame += "\n" + render_serving(fetch_serving())
            # Clear + home, like watch(1); plain newline when not a tty.
            if sys.stdout.isatty():
                sys.stdout.write("\x1b[2J\x1b[H")
            print(frame, flush=True)
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
