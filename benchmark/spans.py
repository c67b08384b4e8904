"""The program's own spans (`lmdx_torch/utils/trace.py::recording`) against
the device trace: each kernel and copy put down to the innermost span the
host was in when it launched it, through the runtime's launch event of the
same correlation id.

- `device_share(names)`: device time (union) of the events launched inside
  spans of `names` or their descendants, over the window;
- `idle_in(names)`: idle time in the gaps whose ending event was launched
  inside those spans, over the window (the gaps of `device_idle_pct`);
- `idle_by_span()`: the idle time by innermost span at the ending event's
  launch, `outside` where no span was open (or the gap ends the window);
  it sums to the window's idle time;
- runtime synchronisations and kernel launches by innermost span.

`readings` gathers them for one window: the shares of PERF.md §3's
program spans, the idle table, the runtime's synchronisations and launches
by span. The harness's traced run does not open `recording()` yet (PERF.md
§7), so nothing here is called by it.
"""

from __future__ import annotations

from benchmark.devtrace import union

OUTSIDE = "outside"


def profiler_events(prof):
    """(device events [(name, start_ns, end_ns, correlation ids)], runtime
    events [(name, start_ns, end_ns, correlation id)]) of a profile."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            dev.append((e.name(), start, end, (e.correlation_id(), e.linked_correlation_id())))
        elif e.correlation_id():
            host.append((e.name(), start, end, e.correlation_id()))
    return dev, host


class SpanView:
    """Device events of the window [w0, w1] (profiler ns) against the
    program's spans, stamped on the profiler's clock.

    dev: [(name, start, end, ids)], ids a tuple of the event's candidate
    correlation ids; runtime: [(name, start, end, id)]; spans: [(name,
    start, end, parent index or None)], parents before their children."""

    def __init__(self, dev, runtime, spans, w0: int, w1: int):
        self.w0, self.w1 = w0, w1
        self.spans = spans
        launch = {cid: s for _, s, _, cid in runtime}
        self.dev = []
        matched = 0
        for name, s, e, ids in dev:
            if e <= w0 or s >= w1:
                continue
            at = next((launch[c] for c in ids if c and c in launch), None)
            matched += at is not None
            self.dev.append((name, max(s, w0), min(e, w1), at))
        self.matched = matched / len(self.dev) if self.dev else 0.0
        self.merged = union([(s, e) for _, s, e, _ in self.dev if e > s])
        self.busy_ns = sum(e - s for s, e in self.merged)
        # Each span's name with its ancestors' names.
        self.chain: list[frozenset] = []
        for name, _, _, parent in spans:
            up = self.chain[parent] if parent is not None else frozenset()
            self.chain.append(up | {name})
        self.runtime = [(n, s) for n, s, _, _ in runtime if w0 <= s < w1]
        self._dev_span = self._innermost([at for *_, at in self.dev])

    @property
    def window_ns(self) -> int:
        return self.w1 - self.w0

    def _innermost(self, times):
        """For each host time (None: unknown), the index of the innermost
        span open then, or None."""
        order = sorted((t, i) for i, t in enumerate(times) if t is not None)
        by_start = sorted(range(len(self.spans)), key=lambda i: self.spans[i][1])
        out = [None] * len(times)
        stack, k = [], 0
        for t, i in order:
            while k < len(by_start) and self.spans[by_start[k]][1] <= t:
                j = by_start[k]
                while stack and self.spans[stack[-1]][2] <= self.spans[j][1]:
                    stack.pop()
                stack.append(j)
                k += 1
            while stack and self.spans[stack[-1]][2] <= t:
                stack.pop()
            out[i] = stack[-1] if stack else None
        return out

    def _within(self, span, names) -> bool:
        return span is not None and not self.chain[span].isdisjoint(names)

    def device_share(self, names) -> float:
        """Share of the window (0..1) the device spent on events launched
        inside spans of `names` or their descendants."""
        names = frozenset(names)
        iv = [(s, e) for (_, s, e, _), span in zip(self.dev, self._dev_span)
              if e > s and self._within(span, names)]
        return sum(e - s for s, e in union(iv)) / self.window_ns

    def gaps(self):
        """[(start, end, innermost span of the ending event's launch)]: the
        device's idle gaps, the last one ending the window (span None)."""
        firsts = sorted(((s, span) for (_, s, e, _), span in zip(self.dev, self._dev_span)
                         if e > s), key=lambda x: x[0])
        out, prev, k = [], self.w0, 0
        for s, e in self.merged + [[self.w1, self.w1]]:
            while k < len(firsts) and firsts[k][0] < s:
                k += 1
            ender = firsts[k][1] if k < len(firsts) and firsts[k][0] == s else None
            if s > prev:
                out.append((prev, s, ender))
            prev = max(prev, e)
        return out

    def idle_in(self, names) -> float:
        """Share of the window (0..1) idle in gaps whose ending event was
        launched inside spans of `names` or their descendants."""
        names = frozenset(names)
        return sum(b - a for a, b, span in self.gaps()
                   if self._within(span, names)) / self.window_ns

    def idle_by_span(self) -> dict[str, float]:
        """{innermost span name or `outside`: idle share of the window}."""
        out: dict[str, float] = {}
        for a, b, span in self.gaps():
            name = self.spans[span][0] if span is not None else OUTSIDE
            out[name] = out.get(name, 0.0) + (b - a) / self.window_ns
        return out

    def runtime_by_span(self, match) -> dict[str, int]:
        """{innermost span name or `outside`: runtime calls whose name
        `match` accepts}."""
        hits = [s for n, s in self.runtime if match(n)]
        out: dict[str, int] = {}
        for span in self._innermost(hits):
            name = self.spans[span][0] if span is not None else OUTSIDE
            out[name] = out.get(name, 0) + 1
        return out


def is_launch(name: str) -> bool:
    return "LaunchKernel" in name


def readings(view: SpanView, host_syncs: dict, units: int, training: bool) -> dict:
    """The window's readings, PERF.md §3's names; `units` images or steps."""
    idle = 1.0 - view.busy_ns / view.window_ns
    by_span = view.idle_by_span()
    out = {"device_idle_pct": 100.0 * idle,
           "idle_by_span_pct": {k: 100.0 * v for k, v in
                                sorted(by_span.items(), key=lambda kv: -kv[1])},
           "idle_sum_pct": 100.0 * sum(by_span.values()),
           "launch_matched": view.matched}
    if training:
        out["optimizer_pct"] = 100.0 * view.device_share({"optimizer"})
        out["param_cast_pct"] = 100.0 * view.device_share({"cast_params"})
        out["forward_pct"] = 100.0 * view.device_share({"forward"})
        out["backward_pct"] = 100.0 * view.device_share({"backward"})
    else:
        out["sam_pct"] = 100.0 * view.device_share({"segment"})
        out["guidance_idle_pct"] = 100.0 * view.idle_in({"guidance"})
        out["guidance_device_pct"] = 100.0 * view.device_share({"guidance"})
        out["syncs_per_image"] = sum(host_syncs.values()) / units if units else None
        out["host_syncs"] = dict(host_syncs)
    # cudaStreamSynchronize: the program's copies and reads (a copy from
    # pageable host memory syncs too); cudaDeviceSynchronize: the probes'
    # span edges and the window's end.
    for kind in ("cudaStreamSynchronize", "cudaDeviceSynchronize"):
        syncs = view.runtime_by_span(lambda n, kind=kind: n == kind)
        out[f"{kind}_per_unit"] = sum(syncs.values()) / units if units else None
        out[f"{kind}_by_span"] = dict(sorted(syncs.items(), key=lambda kv: -kv[1]))
    launches = view.runtime_by_span(is_launch)
    out["launches_per_unit"] = sum(launches.values()) / units if units else None
    out["launches_by_span"] = dict(sorted(launches.items(), key=lambda kv: -kv[1]))
    return out
