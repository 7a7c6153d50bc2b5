"""gap_ms.sample: the mean device-idle time between consecutive launches of
the fused kernel (``fused_kernel``) in ``sample_chain_fused`` calls, ms."""


def read(run):
    trace = run.trace
    if trace is None:
        return None
    launches = [op for op in trace.in_spans("sample_chain_fused")
                if "fused_kernel" in op[2]]
    gaps = [trace.idle_between(a[1], b[0])
            for a, b in zip(launches, launches[1:])]
    return sum(gaps) / len(gaps) * 1e-6 if gaps else None
