"""Hit-calling stage: induction scores, thresholds, plots, outputs (port
of ``saguaro_tpu/pipeline/hits.py``).

Mirrors Inuction_Score_hit.py end to end: induction scores per well, DMSO
quantile thresholds per (plate, timepoint), Bioactivities CSV, DMSO
induction histograms per plate, Venn diagrams (overall + per timepoint),
and per-plate compound x timepoint bioactivity heatmaps — all uploaded
under the output prefix. The PNG deliverables are part of the capability
surface (SURVEY.md C20).

The induction scores run on ``device`` (CUDA unless named). The
Bioactivities CSV is written first; matplotlib and seaborn are imported
where the plots are drawn, so on a machine without them the hit calling and
the CSV are done when the plotting raises ``ImportError``.
"""

from __future__ import annotations

import io
import logging
import re

import torch

from saguaro_tpu_torch.device import resolve_device
from saguaro_tpu_torch.io import storage
from saguaro_tpu_torch.ops.induction import hit_calling
from saguaro_tpu_torch.pipeline.pixel_stages import bucket_path
from saguaro_tpu_torch.plots.venn import venn2

logger = logging.getLogger("saguaro_tpu_torch.hits")

__all__ = ["extract_timepoint_numeric", "run_induction_hit"]


def extract_timepoint_numeric(tp) -> float:
    """Numeric sort key for timepoint strings (Inuction_Score_hit.py:18-21)."""
    match = re.search(r"(\d+)", str(tp))
    return int(match.group(1)) if match else float("inf")


def _save_fig(bucket: str, key: str) -> str:
    import matplotlib.pyplot as plt

    buf = io.BytesIO()
    plt.savefig(buf, format="png", dpi=300, bbox_inches="tight")
    plt.close()
    path = bucket_path(bucket, key)
    storage.write_bytes(path, buf.getvalue())
    logger.info("Uploaded %s", path)
    return path


def run_induction_hit(
    bucket_name: str,
    features_key: str,
    output_prefix: str,
    bioactive_threshold_quantile: float = 0.95,
    induction_threshold: float = 0.95,
    dmso: str = "DMSO",
    device: str | torch.device | None = None,
) -> dict[str, object]:
    """Full hit-calling pass; returns {'bioactivities': path, 'plots': [...],
    'ind_mean': DataFrame, 'thresholds': dict}."""
    dev = resolve_device(device)
    sig = storage.read_csv_sniffed(bucket_path(bucket_name, features_key))
    ind_mean, thresholds, sig_ind = hit_calling(
        sig, bioactive_threshold_quantile, induction_threshold, dmso, device=dev
    )
    bio_path = bucket_path(bucket_name, f"{output_prefix}/Bioactivities_per_plate_doses.csv")
    storage.write_csv(ind_mean.drop(columns=["Bioactive"]), bio_path)
    outputs: dict[str, object] = {
        "bioactivities": bio_path, "ind_mean": ind_mean, "thresholds": thresholds,
    }
    outputs["plots"] = _draw_plots(bucket_name, output_prefix, ind_mean, thresholds, sig_ind, dmso)
    return outputs


def _draw_plots(bucket_name, output_prefix, ind_mean, thresholds, sig_ind, dmso) -> list[str]:
    """The stage's PNGs: per-plate DMSO induction histograms, the Venn
    diagrams (overall and per timepoint) and per-plate bioactivity heatmaps;
    returns their paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import seaborn as sns
    from matplotlib.patches import Patch

    plots = []
    # per-plate DMSO induction distribution histograms (seaborn KDE
    # histplot like the reference, Inuction_Score_hit.py:91)
    dmso_rows = sig_ind[sig_ind["Metadata_Compound"] == dmso]
    for plate_id in dmso_rows["Metadata_Plate"].unique():
        plt.figure(figsize=(12, 8))
        plate_data = dmso_rows[dmso_rows["Metadata_Plate"] == plate_id]
        for tp in sorted(plate_data["Metadata_Timepoint"].unique(), key=extract_timepoint_numeric):
            vals = plate_data[plate_data["Metadata_Timepoint"] == tp]["induction"]
            thr = thresholds.get((plate_id, tp))
            label = f"Timepoint {tp}" + (f" (thresh={thr:.2f})" if thr is not None else "")
            try:
                ax = sns.histplot(vals, bins=100, kde=True, label=label, alpha=0.6)
                color = ax.get_lines()[-1].get_c() if ax.get_lines() else None
            except Exception:  # degenerate data (constant values) breaks KDE
                plt.hist(vals, bins=100, alpha=0.6, label=label)
                color = None
            if thr is not None:
                plt.axvline(x=thr, color=color, linestyle="--", linewidth=2)
        plt.xlabel("Induction Score")
        plt.ylabel("Frequency")
        plt.title(f"DMSO Induction Distribution for Plate: {plate_id}")
        plt.legend()
        plots.append(
            _save_fig(bucket_name, f"{output_prefix}/induction_distribution_plate_{plate_id}.png")
        )

    summary = (
        ind_mean.groupby(["Metadata_Timepoint", "Metadata_Compound"])["Bioactive"]
        .max()
        .reset_index()
    )
    all_compounds = set(summary["Metadata_Compound"])
    bioactive = set(summary.loc[summary["Bioactive"] == 1, "Metadata_Compound"])

    plt.figure(figsize=(8, 5))
    venn2([all_compounds, bioactive], set_labels=("All Compounds", f"Bioactive ({len(bioactive)})"))
    plt.title("Bioactivity Overview (All Plates)")
    plots.append(_save_fig(bucket_name, f"{output_prefix}/venn_all_vs_bioactive.png"))

    if bioactive:
        for tp in summary["Metadata_Timepoint"].unique():
            tp_actives = set(
                summary.loc[
                    (summary["Metadata_Timepoint"] == tp) & (summary["Bioactive"] == 1),
                    "Metadata_Compound",
                ]
            )
            plt.figure(figsize=(8, 6))
            pct = int(len(tp_actives) / len(bioactive) * 100) if bioactive else 0
            venn2(
                [bioactive, tp_actives],
                set_labels=("All Bioactive Compounds", f"Bioactive at {tp} ({pct}%)"),
            )
            plt.title(f"Bioactive Compounds at Timepoint {tp} vs. All Bioactive")
            safe_tp = str(tp).replace(" ", "_").replace("/", "_")
            plots.append(
                _save_fig(bucket_name, f"{output_prefix}/venn_bioactive_vs_all_tp_{safe_tp}.png")
            )
    else:
        logger.warning("No bioactive compounds found; skipping per-timepoint Venns.")

    # per-plate binary bioactivity heatmaps
    hm = ind_mean.copy()
    hm["Metadata_Compound"] = hm["Metadata_Compound"].str.upper()
    tp_order = sorted(hm["Metadata_Timepoint"].unique(), key=extract_timepoint_numeric)
    for plate_id in hm["Metadata_Plate"].unique():
        plate_df = hm[hm["Metadata_Plate"] == plate_id]
        plate_summary = (
            plate_df.groupby(["Metadata_Compound", "Metadata_Timepoint"])["Bioactive"]
            .max()
            .reset_index()
        )
        data = plate_summary.pivot_table(
            index="Metadata_Compound",
            columns="Metadata_Timepoint",
            values="Bioactive",
            fill_value=0,
        ).reindex(columns=tp_order, fill_value=0)
        if data.empty:
            continue
        data["Bioactive"] = (data > 0).any(axis=1).astype(int)
        plt.figure(figsize=(10, max(2, min(20, 0.2 * len(data)))))
        sns.heatmap(
            data,
            cmap=sns.color_palette(["lightgrey", "black"]),
            linewidths=0.5,
            linecolor="black",
            cbar=False,
            annot=False,
            xticklabels=True,
            yticklabels=True,
        )
        plt.title(f"Compound Bioactivity by Timepoint (Plate: {plate_id})", fontsize=12, pad=10)
        plt.xlabel("Timepoint")
        plt.ylabel("Compound")
        plt.xticks(rotation=45, ha="right", fontsize=10)
        plt.yticks(fontsize=6)
        # reference legend/layout contract (Inuction_Score_hit.py:237-241)
        legend_elements = [
            Patch(facecolor="black", label="Active", edgecolor="black")
        ]
        plt.legend(
            handles=legend_elements, loc="upper left",
            bbox_to_anchor=(1.05, 1), borderaxespad=0.0,
        )
        plt.tight_layout()
        plots.append(
            _save_fig(bucket_name, f"{output_prefix}/compound_bioactivity_heatmap_plate_{plate_id}.png")
        )
    return plots
