"""Network plotting (matplotlib instead of the reference's GMT/gnuplot).

Produces: station/measurement map with error ellipses and positional
uncertainty circles; segmentation block graph.

Parity reference: dnaplot capabilities (dnaplot.hpp:111-156) — GMT station
and measurement maps, error ellipses, correction arrows, segmentation
graphs via gnuplot.
"""

from __future__ import annotations

import numpy as np


def plot_network(path: str, net, res=None, seg=None, show_ellipses=True,
                 ellipse_scale=None, title=None, show_corrections=False,
                 correction_scale=None, show_pu=False, initial_coords=None,
                 msr_types: str = "", omit_measurements: bool = False,
                 plot_ignored: bool = False, msr_line_width: float = 0.4,
                 label_stations: bool = False,
                 label_constraints: bool = False,
                 label_corrections: bool = False,
                 label_font_size: float = 6.0,
                 block_number: int = 0, omit_title_block: bool = False,
                 ellipse_magnify: float = 1.0, arrow_magnify: float = 1.0,
                 alternate_name: bool = False, centre=None,
                 area_radius_m: float = 5000.0, bounding_box=None,
                 org_unit: str = "", org_subunit: str = "",
                 plate_boundaries=None):
    """Write a network map (PDF/PNG by extension).

    show_corrections: arrows from initial to adjusted positions (the
    reference's correction arrows; requires initial_coords (lat, lon)
    radian arrays).  show_pu: positional uncertainty circles (95%).
    msr_types: plot only these measurement type codes (--plot-msr-types).
    block_number: restrict to one segmentation block (1-based; needs seg).
    label_*: station name / constraint / correction annotations.
    alternate_name: label stations by description instead of name
    (PLOT_ALT_NAME, dnaplot.cpp:2495).  centre: (lat_deg, lon_deg) to
    centre the plot window, bounded by area_radius_m (the reference's
    --centre-latitude/--centre-longitude/--centre-station/--area-radius).
    bounding_box: (lat1, lon1, lat2, lon2) degrees, upper-left to
    lower-right."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Ellipse

    lat = np.degrees(net.lat)
    lon = np.degrees(net.lon)
    fig, ax = plt.subplots(figsize=(11, 8.5))

    in_block = None
    if block_number and seg is not None:
        b = block_number - 1
        in_block = set(seg.inner_stations[b]) | \
            set(seg.junction_stations[b])

    # measurements as grey lines
    from ..network.screening import stations_of_record
    for rec in (() if omit_measurements else net.measurements):
        if getattr(rec, "ignore", False) and not plot_ignored:
            continue
        if msr_types and getattr(rec, "mtype", "?") not in msr_types:
            continue
        stns = stations_of_record(rec)
        idx = [net.name_to_idx[s] for s in stns if s in net.name_to_idx]
        if in_block is not None and not all(i in in_block for i in idx):
            continue
        for a in range(len(idx) - 1):
            ax.plot([lon[idx[a]], lon[idx[a + 1]]],
                    [lat[idx[a]], lat[idx[a + 1]]],
                    color="0.8", lw=msr_line_width, zorder=1)

    # block colouring from segmentation
    if seg is not None:
        cmap = plt.get_cmap("tab20")
        for b in range(seg.block_count):
            for s in seg.inner_stations[b]:
                ax.plot(lon[s], lat[s], "o", ms=3,
                        color=cmap(b % 20), zorder=3)
            for s in seg.junction_stations[b]:
                ax.plot(lon[s], lat[s], "s", ms=4, color="k", zorder=4)
    else:
        ax.plot(lon, lat, "o", ms=3, color="tab:blue", zorder=3)

    # constrained stations
    for i, cc in enumerate(net.constraints):
        if "C" in cc:
            ax.plot(lon[i], lat[i], "^", ms=7, mfc="none", mec="tab:red",
                    zorder=5)

    # error ellipses (scaled to be visible)
    if res is not None and show_ellipses:
        from ..geodesy.local_frame import rotation_cart_to_local
        from .uncertainty import error_ellipse
        spans = max(lat.max() - lat.min(), lon.max() - lon.min(), 1e-6)
        sds = []
        ell = []
        for i in range(net.nstations):
            Vc = res.station_cov(i)
            R = rotation_cart_to_local(net.lat[i], net.lon[i])
            Vl = R @ Vc @ R.T
            a, b, az = error_ellipse(Vl)
            ell.append((a, b, az))
            sds.append(a)
        if ellipse_scale is None:
            ref = np.median([a for a, _, _ in ell]) or 1.0
            ellipse_scale = 0.02 * spans / ref * ellipse_magnify
        for i, (a, b, az) in enumerate(ell):
            if a <= 0:
                continue
            e = Ellipse((lon[i], lat[i]),
                        width=2 * b * ellipse_scale,
                        height=2 * a * ellipse_scale,
                        angle=-np.degrees(az),
                        fill=False, color="tab:red", lw=0.6, zorder=6)
            ax.add_patch(e)

    # correction arrows (initial → adjusted), magnified to be visible
    if show_corrections and initial_coords is not None:
        lat0, lon0 = initial_coords
        dlat = lat - np.degrees(lat0)
        dlon = lon - np.degrees(lon0)
        mag = np.hypot(dlat, dlon)
        spans = max(lat.max() - lat.min(), lon.max() - lon.min(), 1e-6)
        if correction_scale is None:
            ref = np.median(mag[mag > 0]) if (mag > 0).any() else 1.0
            correction_scale = (0.03 * spans / max(ref, 1e-12) *
                                arrow_magnify)
        for i in range(net.nstations):
            if mag[i] <= 0:
                continue
            ax.annotate("", xy=(lon[i] + dlon[i] * correction_scale,
                                lat[i] + dlat[i] * correction_scale),
                        xytext=(lon[i], lat[i]),
                        arrowprops=dict(arrowstyle="->", color="tab:green",
                                        lw=0.8), zorder=7)

    # positional uncertainty circles (95% circularised)
    if show_pu and res is not None:
        from ..geodesy.local_frame import rotation_cart_to_local
        from .uncertainty import error_ellipse, positional_uncertainty
        from matplotlib.patches import Circle
        spans = max(lat.max() - lat.min(), lon.max() - lon.min(), 1e-6)
        pus = []
        for i in range(net.nstations):
            Vc = res.station_cov(i)
            R = rotation_cart_to_local(net.lat[i], net.lon[i])
            Vl = R @ Vc @ R.T
            a, b, _ = error_ellipse(Vl)
            hp, _vp = positional_uncertainty(a, b, np.sqrt(max(Vl[2, 2],
                                                               0.0)))
            pus.append(hp)
        scale = (0.02 * spans * ellipse_magnify /
                 (np.median([p for p in pus if p > 0]) or 1.0))
        for i, pu in enumerate(pus):
            if pu <= 0:
                continue
            ax.add_patch(Circle((lon[i], lat[i]), pu * scale, fill=False,
                                color="tab:purple", lw=0.5, ls=":",
                                zorder=6))

    # station / constraint labels
    if label_stations or label_constraints:
        for i in range(net.nstations):
            if in_block is not None and i not in in_block:
                continue
            txt = net.names[i] if label_stations else ""
            if label_stations and alternate_name:
                # description as label, "_" when empty (dnaplot.cpp:2498)
                txt = (net.descriptions[i] or "_").strip() or "_"
            if label_constraints and "C" in net.constraints[i]:
                txt = (txt + " " if txt else "") + net.constraints[i]
            if txt:
                ax.annotate(txt, (lon[i], lat[i]),
                            fontsize=label_font_size,
                            xytext=(2, 2), textcoords="offset points",
                            zorder=8)
    if label_corrections and initial_coords is not None:
        lat0, lon0 = initial_coords
        for i in range(net.nstations):
            d = np.hypot(lat[i] - np.degrees(lat0[i]),
                         lon[i] - np.degrees(lon0[i])) * 111320.0
            if d > 1e-6:
                ax.annotate(f"{d:.3f}", (lon[i], lat[i]),
                            fontsize=label_font_size, color="tab:green",
                            xytext=(2, -8), textcoords="offset points",
                            zorder=8)

    if centre is not None:
        clat, clon = centre
        dlat = area_radius_m / 111320.0
        dlon = dlat / max(np.cos(np.radians(clat)), 1e-6)
        ax.set_xlim(clon - dlon, clon + dlon)
        ax.set_ylim(clat - dlat, clat + dlat)
    elif bounding_box is not None:
        lat1, lon1, lat2, lon2 = bounding_box
        ax.set_xlim(min(lon1, lon2), max(lon1, lon2))
        ax.set_ylim(min(lat1, lat2), max(lat1, lat2))
    if plate_boundaries:
        # tectonic plate boundary overlay (--plate-boundary-file;
        # the reference draws these via GMT, dnaplot.hpp:156)
        for _pid, poly in plate_boundaries:
            ax.plot(poly[:, 0], poly[:, 1], color="0.6", lw=0.5,
                    zorder=0)
    ax.set_xlabel("Longitude (°)")
    ax.set_ylabel("Latitude (°)")
    if not omit_title_block:
        ax.set_title(title or f"Network {getattr(net, 'frame', '')} "
                     f"({net.nstations} stations)")
        if org_unit or org_subunit:
            # organisational unit names in the title block
            # (TITLEBLOCK_NAME/SUBNAME, dnaoptions-interface.hpp:276-277)
            sub = " — ".join(s for s in (org_unit, org_subunit) if s)
            ax.text(0.5, 1.05, sub, transform=ax.transAxes,
                    ha="center", fontsize=8)
    ax.set_aspect(1.0 / np.cos(np.radians(lat.mean())))
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    import matplotlib.pyplot as _plt
    _plt.close(fig)
    return path


def plot_segmentation_graph(path: str, seg, title=None):
    """Bar graph of per-block station/measurement counts (the reference's
    gnuplot segmentation graph)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    B = seg.block_count
    inner = [len(seg.inner_stations[b]) for b in range(B)]
    junc = [len(seg.junction_stations[b]) for b in range(B)]
    msrs = [len(seg.measurements[b]) for b in range(B)]
    x = np.arange(B) + 1

    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(11, 8), sharex=True)
    ax1.bar(x, inner, label="inner", color="tab:blue")
    ax1.bar(x, junc, bottom=inner, label="junction", color="tab:orange")
    ax1.set_ylabel("stations")
    ax1.legend()
    ax2.bar(x, msrs, color="tab:green")
    ax2.set_ylabel("measurements")
    ax2.set_xlabel("block")
    ax1.set_title(title or f"Segmentation: {B} blocks")
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def aggregate_pdfs(path: str, net, seg, res=None, title=None):
    """One multi-page PDF with a page per segmentation block (the
    reference aggregates its per-block GMT plots into a single PDF;
    dnaplot.hpp:111-116)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.backends.backend_pdf import PdfPages

    lat = np.degrees(net.lat)
    lon = np.degrees(net.lon)
    with PdfPages(path) as pdf:
        for b in range(seg.block_count):
            in_block = set(seg.inner_stations[b]) | \
                set(seg.junction_stations[b])
            fig, ax = plt.subplots(figsize=(11, 8.5))
            idx = sorted(in_block)
            inner = [i for i in idx if i not in set(seg.junction_stations[b])]
            junc = sorted(set(seg.junction_stations[b]))
            ax.plot(lon[inner], lat[inner], "o", ms=3, color="#1f77b4",
                    label="inner")
            if junc:
                ax.plot(lon[junc], lat[junc], "s", ms=4, color="#d62728",
                        label="junction")
            ax.set_title(f"{title or ''} block {b + 1} "
                         f"({len(inner)} inner, {len(junc)} junction)")
            ax.set_xlabel("Longitude (°)")
            ax.set_ylabel("Latitude (°)")
            ax.legend(loc="best", fontsize=8)
            if len(idx):
                ax.set_aspect(1.0 / np.cos(np.radians(lat[idx].mean())))
            fig.tight_layout()
            pdf.savefig(fig)
            plt.close(fig)
    return path
