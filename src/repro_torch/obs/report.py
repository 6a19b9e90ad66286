"""``python -m repro_torch.obs report <run_dir>``: render a run
directory. Port of ``repro/obs/report.py``.

Host-side formatting of :mod:`repro_torch.obs.runlog` output: the
provenance header, the headline metrics, each event's recovery window,
the flight recorder's timeline, and the timing and memory figures the
producing run put in the manifest.
"""
from __future__ import annotations

from repro_torch.obs import runlog as obl

# manifest keys a run may add, printed under the provenance line
MANIFEST_FIGURES = ("label", "overhead_ratio", "recorder_us_per_step",
                    "baseline_us_per_step", "peak_memory_mb")


def _fmt_val(v) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def _timeline(events: list[dict], limit: int = 60) -> list[str]:
    lines = []
    for e in events[:limit]:
        ent = "fleet" if e["entity"] == -1 else f"player {e['entity']}"
        lines.append(f"  t={e['t']:9.2f}s  step {e['step']:>8}  "
                     f"{e['kind']:<16} {ent:<12} value={e['value']:g}")
    if len(events) > limit:
        lines.append(f"  ... {len(events) - limit} more "
                     f"(see events.json)")
    return lines


def render(run_dir: str) -> str:
    loaded = obl.load_run(run_dir)
    if not loaded:
        return f"{run_dir}: not a run directory (no manifest/metrics)"
    out = [f"run: {run_dir}"]

    man = loaded.get("manifest", {})
    prov = man.get("provenance", {})
    if prov:
        out.append(
            f"  provenance: git {prov.get('git_sha', '?')[:12]}  "
            f"torch {prov.get('torch_version', '?')}  "
            f"cuda {prov.get('cuda_version', '?')}  "
            f"{prov.get('backend', '?')}×{prov.get('device_count', '?')} "
            f"({prov.get('device_name', '?')})  "
            f"config {prov.get('config_hash') or '-'}")
    for key in MANIFEST_FIGURES:
        if key in man:
            out.append(f"  {key}: {_fmt_val(man[key])}")

    ms = loaded.get("metrics")
    if ms is not None:
        out.append("metrics:")
        ev_lines = []
        for name, val in ms.scalars().items():
            line = f"  {name} = {_fmt_val(val)}"
            (ev_lines if name.startswith("repro_event_") else out).append(
                line)
        if ev_lines:
            out.append("recovery windows:")
            out.extend(ev_lines)

    ev = loaded.get("events")
    if ev is not None:
        out.append(
            f"flight recorder: {len(ev['events'])} events retained "
            f"({ev['appended']} appended, {ev['dropped']} lost to "
            f"wraparound)")
        out.extend(_timeline(ev["events"]))

    tr = loaded.get("trace")
    if tr is not None:
        n = len(tr.get("traceEvents", []))
        out.append(f"trace.json: {n} trace events "
                   f"(load in ui.perfetto.dev or chrome://tracing)")

    probs = obl.validate_run(run_dir)
    bad = {f: p for f, p in probs.items() if p}
    out.append("schema validation: "
               + ("OK" if not bad else f"PROBLEMS {bad}"))
    return "\n".join(out)
