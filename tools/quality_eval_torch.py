#!/usr/bin/env python3
"""Round-trip quality of the PyTorch port against the registry's reports.

The counterpart of tools/quality_eval.py for `mbexwn_vocoder_torch`.  For a
registry model (SPEECH, SING or VOICE) it builds the model's held-out v2
corpus with the port's own `make_corpus` (8 utterances, seeds 1099 / 1098 /
1097) under --root, then for every file: analysis -> scale_mel -> synthesis
(PipelinedSynthesizer at batch 1, the blocking loop's audio) -> re-analysis,
with the same metrics and report keys as tools/quality_eval.py (mel-L1 dB,
MCD over cepstra 1..24, F0-RMSE, voicing error; mbexwn_vocoder_torch/
quality.py).  `platform` reads `cuda` or `cpu`, and `device` names the card.

The result is held file by file against the registry's quality_report.json
(bf16 compute, the shipped mode) or quality_report_fp32.json (fp32:
--precision quality); both are printed, and the run fails when the mean
mel-L1 differs from the registry's by more than 0.15 dB.

Usage (from the repo root; on the card unless MBEXWN_PLATFORM=cpu):
    python3 tools/quality_eval_torch.py --model SPEECH [--precision quality] [--out report.json]
"""
import argparse
import glob
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

MAX_MEAN_DELTA_DB = 0.15  # the gate on the mean mel-L1 against the registry's report


def build_corpus(model_id: str, root: str, n: int) -> str:
    """The model's v2 held-out corpus under root (made once, reused)."""
    from mbexwn_vocoder_torch.quality import V2_EVAL_SETS
    from mbexwn_vocoder_torch.training.synthetic import make_corpus

    name, seed, style = V2_EVAL_SETS[model_id]
    out = os.path.join(root, name)
    if len(glob.glob(os.path.join(out, "*.wav"))) < n:
        make_corpus(out, n_utterances=n, seed=seed, style=style, quiet=True)
    return out


def compare(report: dict, registry: dict) -> bool:
    """Print the report beside the registry's, file by file; True when the
    mean mel-L1 is within MAX_MEAN_DELTA_DB of the registry's."""
    reg_rows = {r["file"]: r for r in registry["files"]}
    keys = ("mel_L1_dB", "mcd_dB", "f0_rmse_hz", "voicing_err_pct")
    print(f"{'file':28s} " + "  ".join(f"{k:>22s}" for k in keys) + "   (port / registry)")
    for row in report["files"]:
        reg = reg_rows.get(row["file"], {})
        print(f"{row['file']:28s} " + "  ".join(f"{str(row[k]):>10s} / {str(reg.get(k)):>9s}" for k in keys))
    for k in ("mean_mel_L1_dB", "mean_mcd_dB", "mean_f0_rmse_hz", "mean_voicing_err_pct"):
        print(f"{k:24s} port {report[k]}  registry {registry[k]} ({registry['platform']}, "
              f"{registry['wn_compute_dtype']})")
    delta = report["mean_mel_L1_dB"] - registry["mean_mel_L1_dB"]
    ok = abs(delta) <= MAX_MEAN_DELTA_DB and report["n_files"] == registry["n_files"]
    print(f"gate: mean mel-L1 {report['mean_mel_L1_dB']:.3f} dB vs registry {registry['mean_mel_L1_dB']:.3f} dB: "
          f"delta {delta:+.3f} dB (|delta| <= {MAX_MEAN_DELTA_DB}), {report['n_files']} of {registry['n_files']} "
          f"files: {'ok' if ok else 'FAIL'}")
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--model", required=True, choices=("SPEECH", "SING", "VOICE"))
    ap.add_argument("--precision", choices=("quality", "fast", "default"), default="default",
                    help="as resynth_mel's: quality = fp32, default = the shipped bf16")
    ap.add_argument("--root", default=os.path.join(REPO, ".data_torch"),
                    help="directory of the generated eval corpora")
    ap.add_argument("--out", default=None, help="write the JSON report here")
    ap.add_argument("--max_files", type=int, default=0, help="evaluate only the first N files")
    args = ap.parse_args()

    from mbexwn_vocoder_torch.cli.resynth_mel import apply_precision

    apply_precision(args.precision)  # before the model is built

    import torch

    from mbexwn_vocoder_torch.compat.audio_io import read_wav
    from mbexwn_vocoder_torch.mel_inverter import MELInverter
    from mbexwn_vocoder_torch.platform import platform_device
    from mbexwn_vocoder_torch.quality import N_EVAL_UTTERANCES, round_trip, summarize

    inv = MELInverter(args.model, device=platform_device())
    eval_dir = build_corpus(args.model, args.root, N_EVAL_UTTERANCES)
    files = sorted(glob.glob(os.path.join(eval_dir, "*.wav")))[: args.max_files or None]
    sounds = [(os.path.basename(p), *read_wav(p)) for p in files]
    rows = round_trip(inv, sounds)
    for r in rows:
        print(f"{r['file']:40s} mel-L1 {r['mel_L1_dB']:7.3f} dB  MCD {r['mcd_dB']:6.3f} dB  "
              f"F0-RMSE {r['f0_rmse_hz']} Hz  V-err {r['voicing_err_pct']}%", file=sys.stderr)

    blk = inv.model.block
    wn_dtype = str(blk.wn_compute_dtype or torch.float32).replace("torch.", "")
    report = {"model": args.model, **summarize(rows),
              "platform": inv.device.type,
              "device": torch.cuda.get_device_name(inv.device) if inv.device.type == "cuda" else "cpu",
              "matmul_precision": "highest",  # synthesis runs with TF32 off (ops/precision.py)
              "wn_compute_dtype": wn_dtype,
              "subnet_compute_dtype": str(blk.subnet_compute_dtype or torch.float32).replace("torch.", ""),
              "eval_dir": os.path.relpath(eval_dir, REPO), "files": rows}
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)

    reg_name = "quality_report.json" if wn_dtype == "bfloat16" else "quality_report_fp32.json"
    with open(os.path.join(os.path.dirname(inv.config_file), reg_name)) as f:
        registry = json.load(f)
    if args.max_files:  # hold the first files against the registry's same files
        registry = {**registry, "files": registry["files"][: args.max_files]}
        registry.update(summarize(registry["files"]))
    return 0 if compare(report, registry) else 1


if __name__ == "__main__":
    sys.exit(main())
