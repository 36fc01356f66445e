"""Host parsing and slot assignment.

Reference: horovod/runner/common/util/hosts.py (parse_host_files,
get_host_assignments:100) — hosts are given as ``host1:4,host2:4`` (host:slots)
or a hostfile with ``host slots=N`` lines; assignment produces per-slot
SlotInfo(rank, local_rank, cross_rank, size, local_size, cross_size).

Port of the JAX package's ``runner/hosts.py``, unchanged in meaning. A slot
is a GPU, and the port's launcher starts one process per slot (the JAX
launcher one per host); ranks are assigned host-major.
"""

import dataclasses


@dataclasses.dataclass
class HostInfo:
    hostname: str
    slots: int

    @staticmethod
    def from_string(s):
        if ":" in s:
            host, slots = s.rsplit(":", 1)
            return HostInfo(host, int(slots))
        return HostInfo(s, 1)


@dataclasses.dataclass
class SlotInfo:
    """reference: horovod/runner/common/util/hosts.py SlotInfo."""
    hostname: str
    rank: int
    local_rank: int
    cross_rank: int
    size: int
    local_size: int
    cross_size: int

    def to_response_string(self):
        return ",".join(str(v) for v in (
            self.rank, self.size, self.local_rank, self.local_size,
            self.cross_rank, self.cross_size))


def parse_hosts(hosts_string):
    """``host1:2,host2:2`` -> [HostInfo] (reference: hosts.py parse_hosts)."""
    return [HostInfo.from_string(p) for p in hosts_string.split(",") if p]


def parse_host_files(filename):
    """Hostfile with ``hostname slots=N`` or ``hostname:N`` lines
    (reference: hosts.py parse_host_files)."""
    hosts = []
    with open(filename) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            if "slots=" in line:
                host, _, slots = line.partition("slots=")
                hosts.append(HostInfo(host.strip(), int(slots.strip())))
            else:
                hosts.append(HostInfo.from_string(line))
    return hosts


def get_host_assignments(hosts, min_np, max_np=None):
    """Assign ranks host-major (reference: hosts.py:100 get_host_assignments).

    Returns one SlotInfo per slot, in rank order.
    """
    np_total = sum(h.slots for h in hosts)
    if min_np is not None and np_total < min_np:
        raise ValueError(
            f"Requested np={min_np} but only {np_total} slots available on "
            f"{[h.hostname for h in hosts]}")
    size = min(max_np, np_total) if max_np else (min_np or np_total)

    slots = []
    rank = 0
    cross_size = 0
    for h in hosts:
        if rank >= size:
            break
        cross_size += 1
        take = min(h.slots, size - rank)
        for lr in range(take):
            slots.append(dict(hostname=h.hostname, rank=rank, local_rank=lr,
                              cross_rank=cross_size - 1))
            rank += 1
    local_sizes = {}
    for s in slots:
        local_sizes[s["hostname"]] = local_sizes.get(s["hostname"], 0) + 1
    infos = [SlotInfo(hostname=s["hostname"], rank=s["rank"],
                      local_rank=s["local_rank"], cross_rank=s["cross_rank"],
                      size=size, local_size=local_sizes[s["hostname"]],
                      cross_size=cross_size)
             for s in slots]
    return infos


def host_assignment_by_host(slot_infos):
    """Group SlotInfos per host, in rank order."""
    by_host = {}
    for s in slot_infos:
        by_host.setdefault(s.hostname, []).append(s)
    return by_host
