"""The reference's measurement of the families it checks on its own, written
from CellProfiler 4.2.8's definitions in NumPy and SciPy and independent of
the program and of ``reference/plain``: object counts, the image's
intensity (MeasureImageIntensity), and for each nucleus its number,
location, area, radii (MeasureObjectSizeShape) and intensity
(MeasureObjectIntensity), in each channel. Left out, since their
CellProfiler rule could not be read here to the letter: the per-object
quantiles (median, quartiles, MAD), the edge intensities (which neighbours
make an edge pixel), the median radius and the granularity spectrum (how
the background is mapped back to the sub-sampled grid).

Intensities are on the planes' own integer scale, as the program reports
them (CellProfiler's [0, 1] scale times 65535): every quantity here is
linear in it or free of it."""

from __future__ import annotations

import numpy as np
import pandas as pd
import scipy.ndimage as ndi


def image_intensity(plane: np.ndarray) -> dict:
    """MeasureImageIntensity of one whole plane."""
    v = plane.astype(np.float64).ravel()
    med = np.median(v)
    top = v.max()
    lo, hi = np.percentile(v, [25.0, 75.0])
    return {"TotalIntensity": v.sum(), "MeanIntensity": v.mean(), "StdIntensity": v.std(),
            "MinIntensity": v.min(), "MaxIntensity": top, "MedianIntensity": med,
            "MADIntensity": np.median(np.abs(v - med)), "LowerQuartileIntensity": lo,
            "UpperQuartileIntensity": hi, "TotalArea": float(v.size),
            "PercentMaximal": 100.0 * float((v == top).sum()) / v.size}


def nuclei_table(image: np.ndarray, labels: np.ndarray, channels: list) -> pd.DataFrame:
    """One row a nucleus (label 1..n, every label present): number,
    location, area, radii and each channel's intensity."""
    n = int(labels.max())
    rows = []
    h, w = labels.shape
    for k, sl in enumerate(ndi.find_objects(labels), start=1):
        if sl is None:
            continue
        # one pixel of margin inside the image: outside the image counts as
        # inside the object for the radii, as for a distance transform
        y0, y1 = max(sl[0].start - 1, 0), min(sl[0].stop + 1, h)
        x0, x1 = max(sl[1].start - 1, 0), min(sl[1].stop + 1, w)
        m = labels[y0:y1, x0:x1] == k
        ys, xs = np.nonzero(m)
        dist = ndi.distance_transform_edt(m)[m]
        row = {"ObjectNumber": k, "Number_Object_Number": k, "AreaShape_Area": float(m.sum()),
               "AreaShape_Center_X": xs.mean() + x0, "AreaShape_Center_Y": ys.mean() + y0,
               "Location_Center_X": xs.mean() + x0, "Location_Center_Y": ys.mean() + y0,
               "AreaShape_EquivalentDiameter": np.sqrt(4.0 * m.sum() / np.pi),
               # a square root of a whole number, as the program's float32 holds it
               "AreaShape_MaximumRadius": float(np.float32(dist.max())),
               "AreaShape_MeanRadius": dist.mean()}
        for c, name in enumerate(channels):
            v = image[y0:y1, x0:x1, c][m].astype(np.float64)
            tot = v.sum()
            cy, cx = (ys * v).sum() / tot, (xs * v).sum() / tot
            top = int(np.argmax(v))  # first in raster order
            row.update({
                f"Intensity_IntegratedIntensity_{name}": tot, f"Intensity_MeanIntensity_{name}": v.mean(),
                f"Intensity_StdIntensity_{name}": v.std(), f"Intensity_MinIntensity_{name}": v.min(),
                f"Intensity_MaxIntensity_{name}": v.max(),
                f"Intensity_MassDisplacement_{name}": np.hypot(cy - ys.mean(), cx - xs.mean()),
                f"Location_CenterMassIntensity_X_{name}": cx + x0,
                f"Location_CenterMassIntensity_Y_{name}": cy + y0,
                f"Location_MaxIntensity_X_{name}": float(xs[top] + x0),
                f"Location_MaxIntensity_Y_{name}": float(ys[top] + y0),
            })
        rows.append(row)
    assert len(rows) == n, "labels must run 1..n"
    return pd.DataFrame(rows)


def measure(images: np.ndarray, labels: np.ndarray, channels: list) -> list[dict]:
    """(B, H, W, C) integer planes + (B, H, W) nuclei labels -> a
    {'Image', 'Nuclei'} table dict a site with the columns checked here."""
    out = []
    for img, lab in zip(images, labels):
        row = {"Count_Nuclei": int(lab.max())}
        for c, name in enumerate(channels):
            row.update({f"Intensity_{k}_{name}": v for k, v in image_intensity(img[..., c]).items()})
        out.append({"Image": pd.DataFrame([row]), "Nuclei": nuclei_table(img, lab, channels)})
    return out
