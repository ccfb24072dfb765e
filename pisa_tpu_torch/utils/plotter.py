"""
Host copy of ``pisa_tpu/utils/plotter.py``.

Map/MapSet plotting (cf. reference ``pisa/utils/plotter.py:62``): 1-D
projections and 2-D colormap arrays of binned maps, grids of maps per
MapSet, optional ratio/comparison panels, log axes, and stamps.

matplotlib is an optional dependency: import errors surface only when a
Plotter is actually instantiated.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["Plotter"]


class Plotter:
    """Parameters
    ----------
    outdir : str — where `dump` writes files
    fmt : str or list — file format(s), e.g. 'pdf', 'png'
    stamp : str — text stamp drawn on each panel
    log : bool — log color/means scale
    annotate : bool — write bin values into 2-D cells
    symmetric : bool — symmetric color range around zero
    """

    def __init__(
        self,
        outdir=".",
        stamp=None,
        fmt="pdf",
        log=True,
        annotate=False,
        symmetric=False,
        ratio=False,
    ):
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt  # noqa: F401

        self.outdir = outdir
        self.stamp = stamp
        self.fmt = [fmt] if isinstance(fmt, str) else list(fmt)
        self.log = log
        self.annotate = annotate
        self.symmetric = symmetric
        self.ratio = ratio
        self.fig = None
        self.axes = None
        self._color_cycle = None

    # -- color cycling (cf. reference plotter.py:128-134) -------------------------
    def reset_colors(self):
        import itertools

        import matplotlib.pyplot as plt

        self._color_cycle = itertools.cycle(
            plt.rcParams["axes.prop_cycle"].by_key()["color"]
        )

    def next_color(self):
        if self._color_cycle is None:
            self.reset_colors()
        self.color = next(self._color_cycle)
        return self.color

    def add_leg(self, ax=None):
        """Legend outside the axes (cf. reference plotter.py:166)."""
        import matplotlib.pyplot as plt

        ax = ax or plt.gca()
        handles, labels = ax.get_legend_handles_labels()
        if handles:
            ax.legend(
                handles, labels, loc="upper left",
                bbox_to_anchor=(1.0, 1.0), fontsize=8,
            )

    # -- low-level ---------------------------------------------------------------
    def init_fig(self, figsize=(8, 6)):
        import matplotlib.pyplot as plt

        self.fig, self.axes = plt.subplots(figsize=figsize)
        return self.fig, self.axes

    def add_stamp(self, ax=None, text=None):
        import matplotlib.pyplot as plt

        ax = ax or plt.gca()
        text = text if text is not None else self.stamp
        if text:
            ax.text(
                0.02, 0.98, text, transform=ax.transAxes, va="top",
                ha="left", fontsize=9,
            )

    def dump(self, fname):
        """Save the current figure as `<outdir>/<fname>.<fmt>`."""
        import matplotlib.pyplot as plt

        os.makedirs(self.outdir, exist_ok=True)
        paths = []
        for fmt in self.fmt:
            path = os.path.join(self.outdir, f"{fname}.{fmt}")
            plt.savefig(path, bbox_inches="tight")
            paths.append(path)
        plt.close("all")
        self.fig = None
        return paths

    # -- 2-D maps ------------------------------------------------------------------
    def plot_2d_map(self, map_obj, ax=None, cmap="viridis", **kw):
        """Pseudocolor of a 2-D map (or a 2-D slice of higher-dim maps)."""
        import matplotlib.pyplot as plt
        from matplotlib.colors import LogNorm, Normalize

        if ax is None:
            if self.fig is None:
                self.init_fig()
            ax = self.axes

        binning = map_obj.binning
        hist = np.asarray(map_obj.hist)
        if hist.ndim != 2:
            raise ValueError("plot_2d_map requires a 2-D map")
        x = np.asarray(binning[binning.names[0]].bin_edges.magnitude)
        y = np.asarray(binning[binning.names[1]].bin_edges.magnitude)

        user_vmin = kw.pop("vmin", None)
        user_vmax = kw.pop("vmax", None)
        vmax = np.nanmax(np.abs(hist)) if hist.size else 1.0
        if user_vmin is not None or user_vmax is not None:
            norm = Normalize(vmin=user_vmin, vmax=user_vmax)
            if self.symmetric:
                cmap = kw.pop("cmap", "RdBu_r")
        elif self.symmetric:
            norm = Normalize(vmin=-vmax, vmax=vmax)
            cmap = kw.pop("cmap", "RdBu_r")
        elif self.log and np.all(hist >= 0) and np.nanmax(hist) > 0:
            positive = hist[hist > 0]
            norm = LogNorm(
                vmin=positive.min() if positive.size else 1e-3, vmax=vmax
            )
        else:
            norm = Normalize(vmin=np.nanmin(hist), vmax=vmax)

        pc = ax.pcolormesh(x, y, hist.T, cmap=cmap, norm=norm, **kw)
        plt.colorbar(pc, ax=ax)
        ax.set_xlabel(binning.names[0])
        ax.set_ylabel(binning.names[1])
        if binning[binning.names[0]].is_log:
            ax.set_xscale("log")
        if binning[binning.names[1]].is_log:
            ax.set_yscale("log")
        if self.annotate:
            xc = np.asarray(
                binning[binning.names[0]].weighted_centers.magnitude
            )
            yc = np.asarray(
                binning[binning.names[1]].weighted_centers.magnitude
            )
            for i in range(hist.shape[0]):
                for j in range(hist.shape[1]):
                    ax.text(
                        xc[i], yc[j], f"{hist[i, j]:.3g}", ha="center",
                        va="center", fontsize=6,
                    )
        ax.set_title(map_obj.name)
        self.add_stamp(ax)
        return ax

    def plot_2d_array(self, mapset, fname=None, n_cols=4, **kw):
        """Grid of 2-D maps for a whole MapSet (3-D maps are split along
        their last dimension)."""
        import matplotlib.pyplot as plt

        panels = []
        for m in mapset:
            if len(m.binning.names) == 2:
                panels.append(m)
            elif len(m.binning.names) == 3:
                panels.extend(m.split(m.binning.names[-1]))
            else:
                raise ValueError("can only plot 2-D or 3-D maps")

        n = len(panels)
        n_rows = int(np.ceil(n / n_cols))
        self.fig, axes = plt.subplots(
            n_rows, n_cols, figsize=(4 * n_cols, 3.2 * n_rows), squeeze=False
        )
        for i, m in enumerate(panels):
            self.plot_2d_map(m, ax=axes[i // n_cols][i % n_cols], **kw)
        for j in range(n, n_rows * n_cols):
            axes[j // n_cols][j % n_cols].axis("off")
        if fname:
            return self.dump(fname)
        return self.fig

    # -- 1-D projections --------------------------------------------------------------
    def plot_1d_projection(self, map_obj, axis, ax=None, errors=True, **kw):
        """Histogram-style 1-D projection of a map onto `axis`."""
        import matplotlib.pyplot as plt

        if ax is None:
            if self.fig is None:
                self.init_fig()
            ax = self.axes
        proj = map_obj.project(axis) if len(map_obj.binning.names) > 1 else map_obj
        dim = proj.binning[axis]
        edges = np.asarray(dim.bin_edges.magnitude)
        vals = np.asarray(proj.hist)
        ax.step(
            np.repeat(edges, 2)[1:-1], np.repeat(vals, 2),
            label=map_obj.name, **kw,
        )
        if errors and proj.error_hist is not None:
            centers = np.asarray(dim.weighted_centers.magnitude)
            ax.errorbar(
                centers, vals, yerr=np.asarray(proj.error_hist),
                fmt="none", ecolor="gray", alpha=0.6,
            )
        ax.set_xlabel(axis)
        ax.set_ylabel("counts")
        if dim.is_log:
            ax.set_xscale("log")
        if self.log:
            ax.set_yscale("log")
        self.add_stamp(ax)
        return ax

    def plot_1d_all(self, mapset, axis, fname=None, **kw):
        """All maps of a MapSet projected on one axis, overlaid."""
        import matplotlib.pyplot as plt

        self.init_fig()
        for m in mapset:
            self.plot_1d_projection(m, axis, ax=self.axes, **kw)
        self.axes.legend(fontsize=8)
        if fname:
            return self.dump(fname)
        return self.fig

    def plot_1d_ratio(self, maps, axis, fname=None, **kw):
        """Ratio of 1-D projections relative to the first map."""
        import matplotlib.pyplot as plt

        self.init_fig()
        ref = None
        for m in maps:
            proj = (
                m.project(axis) if len(m.binning.names) > 1 else m
            )
            vals = np.asarray(proj.hist, dtype=np.float64)
            if ref is None:
                ref = vals
                continue
            dim = proj.binning[axis]
            edges = np.asarray(dim.bin_edges.magnitude)
            with np.errstate(divide="ignore", invalid="ignore"):
                ratio = np.where(ref > 0, vals / ref, np.nan)
            self.axes.step(
                np.repeat(edges, 2)[1:-1], np.repeat(ratio, 2),
                label=m.name, **kw,
            )
        self.axes.axhline(1.0, color="k", lw=0.5)
        self.axes.set_xlabel(axis)
        self.axes.set_ylabel("ratio")
        self.axes.legend(fontsize=8)
        self.add_stamp(self.axes)
        if fname:
            return self.dump(fname)
        return self.fig

    # -- reference-API conveniences (cf. reference plotter.py:182-289) -------------

    def plot_2d_single(self, mapset, fname=None, **kw):
        """One figure per map of a MapSet (cf. reference
        ``plotter.py:182``); returns the written paths (or figures)."""
        out = []
        for m in mapset:
            panels = (
                [m]
                if len(m.binning.names) == 2
                else m.split(m.binning.names[-1])
            )
            for p in panels:
                self.init_fig()
                self.plot_2d_map(p, ax=self.axes, **kw)
                if fname is not None:
                    out.extend(self.dump(f"{fname}_{p.name}"))
                else:
                    out.append(self.fig)
        return out

    def plot_1d_array(self, mapset, axis, fname=None, n_cols=4, **kw):
        """Grid of per-map 1-D projections (cf. reference
        ``plotter.py:232``)."""
        import matplotlib.pyplot as plt

        maps = list(mapset)
        n = len(maps)
        n_cols = min(n_cols, max(n, 1))
        n_rows = int(np.ceil(n / n_cols))
        self.fig, axes = plt.subplots(
            n_rows, n_cols, figsize=(4 * n_cols, 3.2 * n_rows),
            squeeze=False,
        )
        for i, m in enumerate(maps):
            ax = axes[i // n_cols][i % n_cols]
            self.plot_1d_projection(m, axis, ax=ax, **kw)
            ax.set_title(m.name)
        for j in range(n, n_rows * n_cols):
            axes[j // n_cols][j % n_cols].axis("off")
        if fname:
            return self.dump(fname)
        return self.fig

    def plot_1d_stack(self, mapset, axis, fname=None, **kw):
        """Stacked (cumulative) 1-D projections of all maps
        (cf. reference ``plotter.py:253``)."""
        self.init_fig()
        self.reset_colors()
        bottom = None
        for m in mapset:
            proj = (
                m.project(axis) if len(m.binning.names) > 1 else m
            )
            dim = proj.binning[axis]
            edges = np.asarray(dim.bin_edges.magnitude)
            vals = np.asarray(proj.hist, dtype=np.float64)
            base = np.zeros_like(vals) if bottom is None else bottom
            top = base + vals
            self.axes.fill_between(
                np.repeat(edges, 2)[1:-1],
                np.repeat(base, 2),
                np.repeat(top, 2),
                label=m.name,
                color=self.next_color(),
                **kw,
            )
            bottom = top
        self.axes.set_xlabel(axis)
        self.axes.set_ylabel("counts")
        if proj.binning[axis].is_log:
            self.axes.set_xscale("log")
        if self.log:
            self.axes.set_yscale("log")
        self.axes.legend(fontsize=8)
        self.add_stamp(self.axes)
        if fname:
            return self.dump(fname)
        return self.fig

    def plot_1d_cmp(self, mapsets, axis, fname=None, labels=None, **kw):
        """Overlaid 1-D projections of several MapSets (summed per set)
        with a ratio panel relative to the first
        (cf. reference ``plotter.py:264``)."""
        import matplotlib.pyplot as plt

        self.fig, (ax0, ax1) = plt.subplots(
            2, 1, sharex=True, figsize=(8, 7),
            gridspec_kw={"height_ratios": [3, 1]},
        )
        self.reset_colors()
        ref_vals = None
        labels = labels or [None] * len(mapsets)
        for ms, label in zip(mapsets, labels):
            maps = list(ms) if not hasattr(ms, "binning") else [ms]
            total = None
            for m in maps:
                proj = (
                    m.project(axis)
                    if len(m.binning.names) > 1
                    else m
                )
                vals = np.asarray(proj.hist, dtype=np.float64)
                total = vals if total is None else total + vals
            dim = proj.binning[axis]
            edges = np.asarray(dim.bin_edges.magnitude)
            color = self.next_color()
            name = label or getattr(ms, "name", None) or maps[0].name
            ax0.step(
                np.repeat(edges, 2)[1:-1], np.repeat(total, 2),
                label=name, color=color, **kw,
            )
            if ref_vals is None:
                ref_vals = total
            with np.errstate(divide="ignore", invalid="ignore"):
                ratio = np.where(ref_vals > 0, total / ref_vals, np.nan)
            ax1.step(
                np.repeat(edges, 2)[1:-1], np.repeat(ratio, 2),
                color=color, **kw,
            )
        ax1.axhline(1.0, color="k", lw=0.5)
        ax1.set_xlabel(axis)
        ax0.set_ylabel("counts")
        ax1.set_ylabel("ratio")
        if dim.is_log:
            ax0.set_xscale("log")
        if self.log:
            ax0.set_yscale("log")
        ax0.legend(fontsize=8)
        self.add_stamp(ax0)
        if fname:
            return self.dump(fname)
        return self.fig

    def plot_1d_slices_array(self, mapsets, axis, fname=None, **kw):
        """Per-slice comparison panels: for every bin of the OTHER
        dimension, overlay the 1-D `axis` slices of all MapSets with a
        ratio panel (cf. reference ``plotter.py:239,324``)."""
        import matplotlib.pyplot as plt

        first = list(mapsets[0])[0]
        names = list(first.binning.names)
        if len(names) < 2:
            raise ValueError("slices need at least a 2-D binning")
        other = [n for n in names if n != axis][0]
        n_slices = first.binning[other].num_bins

        n_cols = min(4, n_slices)
        n_rows = int(np.ceil(n_slices / n_cols))
        self.fig, axes = plt.subplots(
            n_rows, n_cols, figsize=(4 * n_cols, 3.2 * n_rows),
            squeeze=False,
        )
        for s in range(n_slices):
            ax = axes[s // n_cols][s % n_cols]
            self.reset_colors()
            for ms in mapsets:
                total = None
                for m in ms:
                    sliced = m.split(other)[s]
                    proj = (
                        sliced.project(axis)
                        if len(sliced.binning.names) > 1
                        else sliced
                    )
                    vals = np.asarray(proj.hist, dtype=np.float64)
                    total = vals if total is None else total + vals
                dim = proj.binning[axis]
                edges = np.asarray(dim.bin_edges.magnitude)
                ax.step(
                    np.repeat(edges, 2)[1:-1], np.repeat(total, 2),
                    color=self.next_color(),
                    label=getattr(ms, "name", None),
                    **kw,
                )
            ax.set_title(f"{other} bin {s}")
            ax.set_xlabel(axis)
            if dim.is_log:
                ax.set_xscale("log")
        for j in range(n_slices, n_rows * n_cols):
            axes[j // n_cols][j % n_cols].axis("off")
        if fname:
            return self.dump(fname)
        return self.fig
