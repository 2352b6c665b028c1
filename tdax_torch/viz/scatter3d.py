"""Interactive 3-D scatter HTML writer (port of ``tdax/viz/scatter3d.py``).

The reference's plotly express ``scatter_3d`` HTML (visualize.py:51-81):
points coloured by one label set, with symbols by another and hover
text per point, written as one standalone interactive HTML file.  Like
plotly's ``write_html`` with its embedded script, the file opens with
no network access: a small canvas renderer (drag to rotate, wheel to
zoom, hover tooltips, click-to-toggle legend) sits inline, and the file
loads nothing from outside (no http(s) ``src``).  The template, palette,
symbols and trace order are tdax's, so the file is byte-identical to
tdax's for the same inputs.  A static matplotlib PNG accompanies it
unless ``png_fallback=False``; matplotlib is imported only for that PNG.
"""

from __future__ import annotations

import json

import numpy as np

_SYMBOLS = ["circle", "square", "diamond", "cross", "x", "circle-open",
            "square-open", "diamond-open"]
_MPL_MARKERS = ["o", "s", "D", "P", "X", "^", "v", "*"]
_PALETTE = ["#636efa", "#EF553B", "#00cc96", "#ab63fa", "#FFA15A",
            "#19d3f3", "#FF6692", "#B6E880"]

# Self-contained interactive viewer: orthographic trackball projection
# on a 2-D canvas, depth-sorted markers, hover tooltips, legend with
# per-trace visibility toggles.  Everything is inline — the file opens
# with no network access (parity with plotly.write_html's embedded-js
# default, reference visualize.py:62-64).
_TEMPLATE = """<!DOCTYPE html>
<html>
<head><meta charset="utf-8"/>
<style>
body{margin:0;font-family:Helvetica,Arial,sans-serif;background:#fff;}
#title{text-align:center;padding:8px 0 0 0;font-size:17px;color:#2a3f5f;}
#wrap{display:flex;height:95vh;}
#plot{flex:1;cursor:grab;}
#legend{width:230px;overflow-y:auto;padding:10px;font-size:12px;color:#2a3f5f;}
.leg{cursor:pointer;margin:2px 0;white-space:nowrap;user-select:none;}
.leg.off{opacity:0.3;}
.sw{display:inline-block;width:10px;height:10px;border-radius:5px;
    margin-right:6px;vertical-align:middle;}
#tip{position:fixed;display:none;background:rgba(42,63,95,0.95);color:#fff;
     padding:4px 8px;border-radius:3px;font-size:12px;pointer-events:none;
     z-index:10;}
</style>
</head>
<body>
<div id="title"></div>
<div id="wrap"><canvas id="plot"></canvas><div id="legend"></div></div>
<div id="tip"></div>
<script>
var traces = __TRACES__;
var layout = __LAYOUT__;
document.getElementById('title').textContent =
    (layout.title && layout.title.text) || '';
var cv = document.getElementById('plot'), ctx = cv.getContext('2d');
var tip = document.getElementById('tip');
// flatten points; normalize to unit cube around the centroid
var pts = [];
var lo = [1/0, 1/0, 1/0], hi = [-1/0, -1/0, -1/0];
traces.forEach(function (tr, ti) {
  tr.visible = true;
  for (var k = 0; k < tr.x.length; k++) {
    var p = [tr.x[k], tr.y[k], tr.z[k]];
    for (var d = 0; d < 3; d++) {
      if (p[d] < lo[d]) lo[d] = p[d];
      if (p[d] > hi[d]) hi[d] = p[d];
    }
    pts.push({p: p, t: ti, txt: (tr.text && tr.text[k]) || tr.name});
  }
});
var c = [0, 1, 2].map(function (d) { return (lo[d] + hi[d]) / 2; });
var span = Math.max(hi[0]-lo[0], hi[1]-lo[1], hi[2]-lo[2]) || 1;
pts.forEach(function (q) {
  q.n = q.p.map(function (v, d) { return (v - c[d]) / span * 2; });
});
var yaw = 0.6, pitch = -0.4, zoom = 1.0, drag = null;
function draw() {
  var W = cv.clientWidth, H = cv.clientHeight;
  if (cv.width !== W || cv.height !== H) { cv.width = W; cv.height = H; }
  ctx.clearRect(0, 0, W, H);
  var s = Math.min(W, H) * 0.33 * zoom;
  var cy = Math.cos(yaw), sy = Math.sin(yaw);
  var cp = Math.cos(pitch), sp = Math.sin(pitch);
  var proj = pts.map(function (q) {
    if (!traces[q.t].visible) return null;
    var x = q.n[0]*cy + q.n[1]*sy;
    var y1 = -q.n[0]*sy + q.n[1]*cy;
    var y = y1*cp - q.n[2]*sp;
    var z = y1*sp + q.n[2]*cp;
    return {X: W/2 + x*s, Y: H/2 + y*s, Z: z, q: q};
  }).filter(Boolean);
  proj.sort(function (a, b) { return a.Z - b.Z; });
  proj.forEach(function (pr) {
    var tr = traces[pr.q.t], m = tr.marker || {};
    var r = (m.size || 5) * (1 + 0.25*pr.Z) * 0.9 + 1.5;
    mark(pr.X, pr.Y, r, m.color || '#636efa', m.symbol || 'circle');
  });
  cv._proj = proj;
}
function mark(x, y, r, color, sym) {
  var open = /-open$/.test(sym);
  ctx.beginPath();
  if (/^circle/.test(sym)) ctx.arc(x, y, r, 0, 6.2832);
  else if (/^square/.test(sym)) ctx.rect(x-r, y-r, 2*r, 2*r);
  else if (/^diamond/.test(sym)) {
    ctx.moveTo(x, y-r*1.2); ctx.lineTo(x+r*1.2, y);
    ctx.lineTo(x, y+r*1.2); ctx.lineTo(x-r*1.2, y); ctx.closePath();
  } else if (sym === 'cross') {
    var a = r*0.4;
    ctx.rect(x-a, y-r, 2*a, 2*r); ctx.rect(x-r, y-a, 2*r, 2*a);
  } else if (sym === 'x') {
    ctx.save(); ctx.translate(x, y); ctx.rotate(0.7854);
    var a2 = r*0.4;
    ctx.rect(-a2, -r, 2*a2, 2*r); ctx.rect(-r, -a2, 2*r, 2*a2);
    ctx.restore();
  } else ctx.arc(x, y, r, 0, 6.2832);
  if (open) { ctx.strokeStyle = color; ctx.lineWidth = 1.6; ctx.stroke(); }
  else { ctx.fillStyle = color; ctx.fill(); }
}
cv.addEventListener('mousedown', function (e) {
  drag = [e.clientX, e.clientY]; cv.style.cursor = 'grabbing';
});
window.addEventListener('mouseup', function () {
  drag = null; cv.style.cursor = 'grab';
});
window.addEventListener('mousemove', function (e) {
  if (drag) {
    yaw += (e.clientX - drag[0]) * 0.008;
    pitch += (e.clientY - drag[1]) * 0.008;
    pitch = Math.max(-1.55, Math.min(1.55, pitch));
    drag = [e.clientX, e.clientY];
    draw(); return;
  }
  var rect = cv.getBoundingClientRect();
  var mx = e.clientX - rect.left, my = e.clientY - rect.top;
  var best = null, bd = 81;
  (cv._proj || []).forEach(function (pr) {
    var d = (pr.X-mx)*(pr.X-mx) + (pr.Y-my)*(pr.Y-my);
    if (d < bd) { bd = d; best = pr; }
  });
  if (best) {
    tip.style.display = 'block';
    tip.style.left = (e.clientX + 12) + 'px';
    tip.style.top = (e.clientY + 12) + 'px';
    tip.textContent = best.q.txt;
  } else tip.style.display = 'none';
});
cv.addEventListener('wheel', function (e) {
  e.preventDefault();
  zoom *= Math.exp(-e.deltaY * 0.001);
  zoom = Math.max(0.2, Math.min(8, zoom));
  draw();
}, {passive: false});
var leg = document.getElementById('legend');
traces.forEach(function (tr, ti) {
  var el = document.createElement('div');
  el.className = 'leg';
  var sw = document.createElement('span');
  sw.className = 'sw';
  sw.style.background = (tr.marker && tr.marker.color) || '#636efa';
  el.appendChild(sw);
  el.appendChild(document.createTextNode(tr.name || ('trace ' + ti)));
  el.onclick = function () {
    tr.visible = !tr.visible;
    el.className = tr.visible ? 'leg' : 'leg off';
    draw();
  };
  leg.appendChild(el);
});
window.addEventListener('resize', draw);
draw();
</script>
</body>
</html>
"""


def write_scatter3d_html(cloud: np.ndarray, color_labels, symbol_labels,
                         hover_text, out_path: str, title: str = "",
                         png_fallback: bool = True) -> None:
    """Write ``cloud`` ([n, 3]) as an interactive HTML scatter, one trace
    per (colour, symbol) pair in sorted order, and beside it a PNG of the
    same points when ``png_fallback``."""
    cloud = np.asarray(cloud, dtype=float)
    color_labels = [str(c) for c in color_labels]
    symbol_labels = [str(s) for s in symbol_labels]
    hover_text = [str(h) for h in hover_text]

    uniq_colors = sorted(set(color_labels))
    uniq_symbols = sorted(set(symbol_labels))
    traces = []
    for ci, cval in enumerate(uniq_colors):
        for si, sval in enumerate(uniq_symbols):
            sel = [k for k in range(len(cloud))
                   if color_labels[k] == cval and symbol_labels[k] == sval]
            if not sel:
                continue
            traces.append({
                "type": "scatter3d",
                "mode": "markers",
                "name": f"{cval}, {sval}",
                "x": cloud[sel, 0].tolist(),
                "y": cloud[sel, 1].tolist(),
                "z": cloud[sel, 2].tolist(),
                "text": [hover_text[k] for k in sel],
                "hoverinfo": "text",
                "marker": {
                    "size": 5,
                    "color": _PALETTE[ci % len(_PALETTE)],
                    "symbol": _SYMBOLS[si % len(_SYMBOLS)],
                },
            })
    layout = {
        "title": {"text": title},
        "template": "plotly_white",
        "scene": {"xaxis": {"title": "x"}, "yaxis": {"title": "y"},
                  "zaxis": {"title": "z"}},
    }
    html = (_TEMPLATE
            .replace("__TRACES__", json.dumps(traces))
            .replace("__LAYOUT__", json.dumps(layout)))
    with open(out_path, "w") as f:
        f.write(html)

    if png_fallback:
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
        fig = plt.figure(figsize=(8, 7))
        ax = fig.add_subplot(projection="3d")
        for ci, cval in enumerate(uniq_colors):
            for si, sval in enumerate(uniq_symbols):
                sel = [k for k in range(len(cloud))
                       if color_labels[k] == cval and symbol_labels[k] == sval]
                if not sel:
                    continue
                ax.scatter(cloud[sel, 0], cloud[sel, 1], cloud[sel, 2],
                           c=_PALETTE[ci % len(_PALETTE)],
                           marker=_MPL_MARKERS[si % len(_MPL_MARKERS)], s=24,
                           label=f"{cval}, {sval}" if len(uniq_symbols) == 1 else None)
        ax.set_title(title)
        if len(uniq_symbols) == 1:
            ax.legend(fontsize=7, loc="upper left", ncol=2)
        fig.savefig(out_path.rsplit(".", 1)[0] + ".png", dpi=110)
        plt.close(fig)
