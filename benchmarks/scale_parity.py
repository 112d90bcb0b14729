"""Head-to-head identify parity at E. coli scale (round-3 VERDICT #1, #7).

Runs over the persistent fixture from benchmarks/scale_fixture.py
(1647 strains / 28.6M-k-mer DB).  Three modes so the slow halves can run
independently:

    python benchmarks/scale_parity.py ours    # our identify, cold+warm
    python benchmarks/scale_parity.py ref     # reference CLI (jellyfish)
    python benchmarks/scale_parity.py diff    # field-diff + PARITY json

`diff` writes PARITY_SCALE_r04.json (override: $PARITY_OUT) at the repo root with per-sample
byte/field equality and the cold/warm timings.
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

SCALE = os.path.join(REPO, ".scale")
OUT = os.path.join(SCALE, "parity")
SAMPLES = ("single", "crossmix", "intramix")

# fields that pass through sklearn/our coordinate descent: numeric compare
ENET_FIELDS = {
    "Relative_Abundance", "Relative_Abundance_Inside_Cluster",
    "Predicted_Depth (Enet)", "Predicted_Depth (Ab*cls_depth)",
}


def run_ours():
    from strainscan_tpu.config import IdentifyConfig
    from strainscan_tpu.identify.pipeline import run_identify

    db = os.path.join(SCALE, "DB")
    timings = {}
    from strainscan_tpu.utils.profiling import PHASE_TIMES

    phases = {}

    def snap(tag):
        phases[tag] = {k: round(v, 2) for k, v in PHASE_TIMES.items()
                       if k.startswith(("identify/", "l2/"))}
        PHASE_TIMES.clear()

    for i, s in enumerate(SAMPLES):
        fq = os.path.join(SCALE, "samples", s + ".fq")
        out = os.path.join(OUT, "ours_" + s)
        t0 = time.time()
        run_identify(fq, "", db, out, IdentifyConfig())
        timings[s] = round(time.time() - t0, 1)
        snap(s)
        print(f"ours {s}: {timings[s]}s {phases[s]}", flush=True)
    # warm steady-state: rerun the first sample in-process (table resident,
    # jit cached) — the per-sample latency a serving deployment would see
    for s in SAMPLES:
        fq = os.path.join(SCALE, "samples", s + ".fq")
        t0 = time.time()
        run_identify(fq, "", db, os.path.join(OUT, "ours_warm_" + s),
                     IdentifyConfig())
        timings["warm_" + s] = round(time.time() - t0, 1)
        snap("warm_" + s)
        print(f"ours warm {s}: {timings['warm_' + s]}s {phases['warm_' + s]}",
              flush=True)
    timings["phases"] = phases
    with open(os.path.join(OUT, "ours_timings.json"), "w") as f:
        json.dump(timings, f)


def run_ref():
    from ref_harness import run_reference

    refdb = os.path.join(SCALE, "REFDB")
    timings = {}
    for s in SAMPLES:
        fq = os.path.join(SCALE, "samples", s + ".fq")
        out = os.path.join(OUT, "ref_" + s)
        t0 = time.time()
        r = run_reference(
            "StrainScan.py", ["-i", fq, "-d", refdb, "-o", out],
            os.path.join(OUT, "wk_" + s), timeout=14400)
        timings[s] = round(time.time() - t0, 1)
        print(f"ref {s}: {timings[s]}s rc={r.returncode}", flush=True)
        if r.returncode != 0:
            print(r.stderr[-4000:], flush=True)
    with open(os.path.join(OUT, "ref_timings.json"), "w") as f:
        json.dump(timings, f)


def field_diff(ours_path, ref_path):
    from ref_harness import parse_report

    a = open(ours_path).read()
    b = open(ref_path).read()
    if a == b:
        return {"byte_identical": True, "rows": a.count("\n") - 1}
    ra, rb = parse_report(ours_path), parse_report(ref_path)
    if len(ra) != len(rb):
        return {"byte_identical": False, "error":
                f"row count {len(ra)} vs {len(rb)}"}
    worst = 0.0
    for x, y in zip(ra, rb):
        for fld, va in x.items():
            vb = y.get(fld)
            if va == vb:
                continue
            if fld not in ENET_FIELDS:
                return {"byte_identical": False,
                        "error": f"non-Enet field {fld}: {va!r} vs {vb!r}"}
            rel = abs(float(va) - float(vb)) / max(abs(float(vb)), 1e-30)
            worst = max(worst, rel)
    return {"byte_identical": False, "enet_rel_err": worst,
            "fields_ok": worst < 1e-6, "rows": len(ra)}


def run_diff():
    meta = json.load(open(os.path.join(SCALE, "meta.json")))
    res = {
        "what": ("identify parity vs the ACTUAL reference CLI on the "
                 "E. coli-scale fixture (BASELINE target row: 1433 strains "
                 "/ 823 clusters; fixture: 1647 strains / "
                 f"{meta['n_clusters']} clusters, 28.6M-k-mer DB)"),
        "db": {"strains": len(meta["strains"]),
               "clusters": meta["n_clusters"],
               "build_s": meta.get("build_s"),
               "build_phases": meta.get("build_phases")},
        "samples": {},
    }
    for s in SAMPLES:
        ours = os.path.join(OUT, "ours_" + s, "final_report.txt")
        ref = os.path.join(OUT, "ref_" + s, "final_report.txt")
        if not (os.path.exists(ours) and os.path.exists(ref)):
            res["samples"][s] = {"error": "missing report"}
            continue
        d = field_diff(ours, ref)
        truth = meta["samples"][s]["truth"]
        from ref_harness import parse_report

        names = {r["Strain_Name"].split()[0]
                 for r in parse_report(ref)}
        d["truth_found"] = all(t in names for t in truth)
        res["samples"][s] = d
    for fn, key in (("ours_timings.json", "ours_s"),
                    ("ref_timings.json", "ref_s")):
        p = os.path.join(OUT, fn)
        if os.path.exists(p):
            res[key] = json.load(open(p))
    ok = all(v.get("byte_identical") or v.get("fields_ok")
             for v in res["samples"].values())
    res["parity"] = ok
    out = os.path.join(REPO, os.environ.get(
        "PARITY_OUT", "PARITY_SCALE_r04.json"))
    with open(out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))
    return 0 if ok else 1


def main():
    os.makedirs(OUT, exist_ok=True)
    mode = sys.argv[1] if len(sys.argv) > 1 else "diff"
    if mode == "ours":
        run_ours()
    elif mode == "ref":
        run_ref()
    else:
        return run_diff()
    return 0


if __name__ == "__main__":
    sys.exit(main())
