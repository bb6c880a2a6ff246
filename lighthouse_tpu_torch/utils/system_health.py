"""Host/process health gauges (common/system_health equivalent).

Pure /proc + os.statvfs — no psutil dependency.  `snapshot()` returns
the UI-facing dict and refreshes the prometheus gauges.
"""
from __future__ import annotations

import os
import resource
import time

from ..api import metrics_defs

#: (wall seconds, cpu seconds) at the previous snapshot; CPU percent is
#: the utime+stime delta over the wall delta between snapshots
_cpu_mark: tuple[float, float] | None = None


def _cpu_seconds() -> float:
    """Process CPU time (utime+stime, self) from getrusage."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def _cpu_percent() -> float:
    global _cpu_mark
    now = time.monotonic()
    cpu = _cpu_seconds()
    mark, _cpu_mark = _cpu_mark, (now, cpu)
    if mark is None:
        return 0.0
    wall_d = now - mark[0]
    if wall_d <= 0:
        return 0.0
    return max(0.0, 100.0 * (cpu - mark[1]) / wall_d)


def _open_fds() -> int:
    """Open fd count via /proc; -1 where /proc is unavailable."""
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return -1


def _meminfo() -> dict[str, int]:
    out = {}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2 and parts[0].endswith(":"):
                    out[parts[0][:-1]] = int(parts[1]) * 1024
    except OSError:
        pass
    return out


def snapshot(data_dir: str = "/") -> dict:
    la1 = la5 = la15 = 0.0
    try:
        la1, la5, la15 = os.getloadavg()
    except OSError:
        pass
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    mem = _meminfo()
    try:
        st = os.statvfs(data_dir)
        disk_free = st.f_bavail * st.f_frsize
        disk_total = st.f_blocks * st.f_frsize
    except OSError:
        disk_free = disk_total = 0
    out = {
        "sys_loadavg_1": la1, "sys_loadavg_5": la5, "sys_loadavg_15": la15,
        "sys_virt_mem_total": mem.get("MemTotal", 0),
        "sys_virt_mem_available": mem.get("MemAvailable", 0),
        "app_mem_process_resident_set_size": rss,
        "disk_node_bytes_total": disk_total,
        "disk_node_bytes_free": disk_free,
        "network_node_bytes_total_received": 0,
        "network_node_bytes_total_transmit": 0,
    }
    fds = _open_fds()
    if fds >= 0:
        out["process_num_open_file_descriptors"] = fds
        metrics_defs.gauge("process_open_fds", fds)
    metrics_defs.gauge("system_load_1m", la1)
    metrics_defs.gauge("process_resident_memory_bytes", rss)
    metrics_defs.gauge("system_disk_free_bytes", disk_free)
    metrics_defs.gauge("process_cpu_percent", _cpu_percent())
    return out


def sample_gauges() -> None:
    """Cheap per-slot host-health feed for the graftwatch rings (the
    full :func:`snapshot` does statvfs + meminfo too — overkill at slot
    cadence).  Called from ``obs.device.publish`` each slot so RSS/CPU
    trajectories land in the timeseries, not just on-demand snapshots."""
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    metrics_defs.gauge("process_resident_memory_bytes", rss)
    metrics_defs.gauge("process_cpu_percent", _cpu_percent())
    try:
        metrics_defs.gauge("system_load_1m", os.getloadavg()[0])
    except OSError:
        pass
    fds = _open_fds()
    if fds >= 0:
        metrics_defs.gauge("process_open_fds", fds)
