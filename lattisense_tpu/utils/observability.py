"""Observability: task progress + host/device memory monitoring.

Reference parity:
- TaskProgressBar / throttled ProgressCallback(completed, total)
  (tools/task_progress_bar.h:31, mega_ag_runners/cpu_task_utils.h:414).
- MemoryMonitor: 100 ms /proc/self/status sampler → crash-safe CSV
  (mega_ag_runners/cpu_mem_monitor.h:34); GpuMemoryMonitor equivalent
  reports the device memory stats jax exposes.
- tools/plot_mem.py counterpart lives in tools/plot_mem.py.
"""

import os
import threading
import time


class TaskProgressBar:
    """Stderr block progress bar, throttled to ``interval_ms``."""

    def __init__(self, total: int, width: int = 40, interval_ms: int = 100):
        self.total = max(total, 1)
        self.width = width
        self.interval = interval_ms / 1e3
        self._last = 0.0

    def __call__(self, completed: int, total: int | None = None):
        import sys
        total = total or self.total
        now = time.monotonic()
        if completed < total and now - self._last < self.interval:
            return
        self._last = now
        frac = completed / total
        filled = int(self.width * frac)
        bar = '█' * filled + '░' * (self.width - filled)
        end = '\n' if completed >= total else '\r'
        print(f'[{bar}] {completed}/{total} ({frac:6.1%})', file=sys.stderr,
              end=end, flush=True)


def _read_proc_status():
    vals = {}
    try:
        with open('/proc/self/status') as f:
            for line in f:
                if line.startswith(('VmRSS', 'VmHWM', 'AnonHugePages')):
                    k, v = line.split(':', 1)
                    vals[k] = int(v.strip().split()[0])  # kB
    except OSError:
        pass
    return vals


def device_memory_stats():
    """Per-device {bytes_in_use, bytes_limit} where the backend reports it."""
    import jax
    out = {}
    for d in jax.devices():
        try:
            s = d.memory_stats()
            if s:
                out[str(d)] = {'bytes_in_use': s.get('bytes_in_use', 0),
                               'bytes_limit': s.get('bytes_limit', 0)}
        except Exception:
            pass
    return out


class MemoryMonitor:
    """Background sampler → CSV, flushed per line (crash-safe, like the
    reference's monitor). Enabled under LATTISENSE_DEV like the reference."""

    def __init__(self, interval_ms: int = 100, with_device: bool = False):
        self.interval = interval_ms / 1e3
        self.with_device = with_device
        self._stop = threading.Event()
        self._thread = None
        self._file = None

    @staticmethod
    def next_csv_path(prefix: str = 'mem_usage', directory: str = '.') -> str:
        i = 0
        while True:
            path = os.path.join(directory, f'{prefix}_{i}.csv')
            if not os.path.exists(path):
                return path
            i += 1

    def start(self, csv_path: str):
        self._file = open(csv_path, 'w')
        cols = 'time_s,vmrss_kb,vmhwm_kb,anon_huge_kb'
        if self.with_device:
            cols += ',device_bytes_in_use'
        self._file.write(cols + '\n')
        self._t0 = time.monotonic()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            vals = _read_proc_status()
            row = (f'{time.monotonic() - self._t0:.3f},'
                   f"{vals.get('VmRSS', 0)},{vals.get('VmHWM', 0)},"
                   f"{vals.get('AnonHugePages', 0)}")
            if self.with_device:
                dev = device_memory_stats()
                used = sum(v['bytes_in_use'] for v in dev.values())
                row += f',{used}'
            self._file.write(row + '\n')
            self._file.flush()
            self._stop.wait(self.interval)

    def stop(self):
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._file.close()
        self._thread = None


def dev_mode_enabled() -> bool:
    return os.environ.get('LATTISENSE_DEV', '') not in ('', '0')


class trace:
    """Device-level tracing context: wraps ``jax.profiler.trace`` so a task
    run (or any region) produces a TensorBoard/perfetto-loadable trace —
    this framework's replacement for the reference's compile-flag wall-time
    prints (LATTISENSE_PRINT_PROFILE, CMakeLists.txt:268-271).

        with observability.trace('/tmp/fhe_trace'):
            task.run(ctx, args)
    """

    def __init__(self, log_dir: str, create_perfetto_link: bool = False):
        self.log_dir = log_dir
        self.create_perfetto_link = create_perfetto_link

    def __enter__(self):
        import jax
        jax.profiler.start_trace(
            self.log_dir, create_perfetto_link=self.create_perfetto_link)
        return self

    def __exit__(self, *exc):
        import jax
        jax.profiler.stop_trace()
        return False


def xla_cost_analysis(fn, *args, **kwargs):
    """Compile ``fn`` for the current backend and return XLA's per-program
    cost analysis: {'flops', 'bytes accessed', 'utilization operand', ...} —
    the per-op cost-model hook SURVEY §5 prescribes for profiling (the
    reference has no analog; its only profile signal is wall time). Values
    are floats as reported by the compiled executable.

    Use together with the ns-return convention of ``FheTaskTpu.run`` to
    separate compute-bound from bandwidth-bound regressions:

        cost = xla_cost_analysis(fn, a, b, keys)
        ai = cost['flops'] / cost['bytes accessed']   # arithmetic intensity
    """
    import jax
    compiled = jax.jit(fn).lower(*args, **kwargs).compile()
    cost = compiled.cost_analysis()
    # jax returns either a dict or a 1-element list of dicts by version
    if isinstance(cost, (list, tuple)):
        cost = cost[0] if cost else {}
    return dict(cost or {})
