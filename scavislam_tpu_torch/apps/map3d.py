"""Interactive 3-D map/graph viewer: one self-contained HTML file (port of
scavislam_tpu.apps.map3d).

The reference's interactive 3-D map view (stereo_slam.cpp:124-162 `v_graph`
+ Draw3d scene: keyframe frusta, map points, covisibility edges coloured by
type and marginalization state, the trajectory, with mouse orbit/pan/zoom
via Pangolin's 3-D handler) rendered into ONE dependency-free HTML file
(inline data and a small canvas renderer, no network access needed): open
it in any browser, orbit with the mouse, toggle layers. The view pose
persists in localStorage, so watch-mode refreshes (the file is re-exported
every tick) keep the camera.

Scene parity with the reference 3-D view (stereo_slam.cpp:497-565):
- keyframes as camera frusta (the active keyframe highlighted),
- map points as a decimated world-space point cloud,
- graph edges coloured LOCAL/METRIC/APPEARANCE, marginalized edges dimmed,
- estimated trajectory (and ground truth when available).

The scene and the template are the twin's: given the same graph, the port
writes the same bytes. Host numpy; poses given as device tensors (a
synthetic sequence's ground truth on the card) are downloaded.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from scavislam_tpu_torch.models.slam_graph import APPEARANCE, LOCAL, METRIC

MAX_POINTS = 60_000  # decimation cap: keeps the file small and the canvas fluid


def _host(a):
    """A pose field on the host (ground truth may live on the card)."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a


def _round(a, nd=4):
    return np.round(np.asarray(a, np.float64), nd).tolist()


def extract_scene(graph, trajectory=None, gt_poses=None, actkey_id=None):
    """Graph -> JSON-ready scene dict (all world-frame, host numpy)."""
    kf_ids, centers, rots = [], [], []
    index = {}
    for k, v in graph.vertices.items():
        index[k] = len(kf_ids)
        kf_ids.append(int(k))
        R = np.asarray(v.R, np.float64)
        t = np.asarray(v.t, np.float64)
        centers.append(-R.T @ t)   # camera center in world
        rots.append(R.reshape(-1))  # R_cw row-major (world->cam)
    pts = []
    for p in graph.points.values():
        if p.anchor_id in graph.vertices:
            v = graph.vertices[p.anchor_id]
            psi = np.asarray(p.psi, np.float64)
            if abs(psi[2]) < 1e-12:
                continue
            xyz_a = np.array([psi[0] / psi[2], psi[1] / psi[2], 1.0 / psi[2]])
            pts.append(np.asarray(v.R, np.float64).T
                       @ (xyz_a - np.asarray(v.t, np.float64)))
    if len(pts) > MAX_POINTS:
        sel = np.linspace(0, len(pts) - 1, MAX_POINTS).astype(int)
        pts = [pts[i] for i in sel]
    edges = []
    for (a, b), e in graph.edges.items():
        if a in index and b in index:
            edges.append([index[a], index[b], int(e.edge_type),
                          1 if e.is_marginalized() else 0])

    def _traj(poses):
        out = []
        for T in poses:
            R = np.asarray(_host(T.R), np.float64)
            out.append(-R.T @ np.asarray(_host(T.t), np.float64))
        return _round(np.asarray(out).reshape(-1, 3)) if out else []

    traj = _traj([T for _fid, T in trajectory]) if trajectory else []
    gt = _traj(list(gt_poses)) if gt_poses else []
    return {
        "kf_ids": kf_ids,
        "kf_centers": _round(np.asarray(centers).reshape(-1, 3)
                             if centers else np.zeros((0, 3))),
        "kf_rots": _round(np.asarray(rots).reshape(-1, 9)
                          if rots else np.zeros((0, 9))),
        "actkey": index.get(actkey_id, -1),
        "points": _round(np.asarray(pts).reshape(-1, 3)
                         if pts else np.zeros((0, 3)), 3),
        "edges": edges,
        "traj": traj,
        "gt": gt,
        "edge_types": {"LOCAL": int(LOCAL), "METRIC": int(METRIC),
                       "APPEARANCE": int(APPEARANCE)},
    }


_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>scavislam_tpu 3-D map</title>
<style>
  html,body{margin:0;height:100%;background:#121218;color:#ddd;
            font:12px/1.4 system-ui,sans-serif;overflow:hidden}
  #c{display:block;width:100vw;height:100vh;cursor:grab}
  #hud{position:fixed;top:8px;left:8px;background:rgba(18,18,24,.85);
       border:1px solid #333;border-radius:6px;padding:8px 10px;user-select:none}
  #hud label{display:block;cursor:pointer}
  #stat{position:fixed;bottom:8px;left:8px;color:#999}
  #help{position:fixed;bottom:8px;right:8px;color:#777;text-align:right}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud">
  <b>scavislam_tpu map</b><br>
  <label><input type="checkbox" id="tPts" checked> points (<span id="nPts"></span>)</label>
  <label><input type="checkbox" id="tKf" checked> keyframes (<span id="nKf"></span>)</label>
  <label><input type="checkbox" id="tEdg" checked> edges (<span id="nEdg"></span>)</label>
  <label><input type="checkbox" id="tTraj" checked> trajectory</label>
  <label><input type="checkbox" id="tGt" checked> ground truth</label>
  <label><input type="checkbox" id="tMarg" checked> marginalized edges</label>
</div>
<div id="stat"></div>
<div id="help">drag orbit &middot; shift/right-drag pan &middot; wheel zoom &middot; dblclick reset</div>
<script>
const SCENE = __SCENE_JSON__;
const cvs = document.getElementById('c'), ctx = cvs.getContext('2d');
const COLORS = {}; // edge_type -> css
COLORS[SCENE.edge_types.LOCAL] = [90,110,230];
COLORS[SCENE.edge_types.METRIC] = [80,200,120];
COLORS[SCENE.edge_types.APPEARANCE] = [240,120,70];

// --- scene bounds -> default view ---------------------------------------
const all = SCENE.kf_centers.concat(SCENE.traj, SCENE.gt,
                                    SCENE.points.slice(0, 5000));
let ctr=[0,0,0], rad=1;
if (all.length) {
  let lo=[1e30,1e30,1e30], hi=[-1e30,-1e30,-1e30];
  for (const p of all) for (let i=0;i<3;i++){
    lo[i]=Math.min(lo[i],p[i]); hi[i]=Math.max(hi[i],p[i]);}
  ctr=[(lo[0]+hi[0])/2,(lo[1]+hi[1])/2,(lo[2]+hi[2])/2];
  rad=Math.max(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2],0.5);
}
const DEF = {yaw:0.6, pitch:0.45, dist:rad*2.2,
             tgt:ctr.slice(), fl:900};
let view = JSON.parse(localStorage.getItem('svtpu_view_'+location.pathname)
                      || 'null') || JSON.parse(JSON.stringify(DEF));

function saveView(){ localStorage.setItem(
  'svtpu_view_'+location.pathname, JSON.stringify(view)); }

// --- projection ----------------------------------------------------------
let W,H,basis;
function computeBasis(){
  const cy=Math.cos(view.yaw), sy=Math.sin(view.yaw);
  const cp=Math.cos(view.pitch), sp=Math.sin(view.pitch);
  // camera looks at tgt from spherical (yaw around y, pitch up)
  const fwd=[-sy*cp, -sp, -cy*cp];           // cam -> tgt direction
  const right=[cy,0,-sy];
  const up=[ -sy*sp, cp, -cy*sp ];
  const eye=[view.tgt[0]-fwd[0]*view.dist,
             view.tgt[1]-fwd[1]*view.dist,
             view.tgt[2]-fwd[2]*view.dist];
  basis={eye,right,up,fwd};
}
function proj(p, out){
  const e=basis.eye;
  const dx=p[0]-e[0], dy=p[1]-e[1], dz=p[2]-e[2];
  const z = dx*basis.fwd[0]+dy*basis.fwd[1]+dz*basis.fwd[2];
  if (z < 1e-3) return false;
  const x = dx*basis.right[0]+dy*basis.right[1]+dz*basis.right[2];
  const y = dx*basis.up[0]+dy*basis.up[1]+dz*basis.up[2];
  out[0] = W/2 + view.fl*x/z;
  out[1] = H/2 - view.fl*y/z;
  out[2] = z;
  return true;
}

// --- render ---------------------------------------------------------------
const a=[0,0,0], b=[0,0,0];
function frustum(i){ // 5 world-space points of a small camera pyramid
  const c=SCENE.kf_centers[i], R=SCENE.kf_rots[i];
  const s=rad*0.02;
  // R is R_cw (world->cam, row-major): camera axis k in world = R^T e_k = row k
  const ex=[R[0],R[1],R[2]], ey=[R[3],R[4],R[5]], ez=[R[6],R[7],R[8]];
  const pts=[c];
  for (const [su,sv] of [[-1,-1],[1,-1],[1,1],[-1,1]]) {
    pts.push([c[0]+s*(su*1.3*ex[0]+sv*ey[0]+2*ez[0]),
              c[1]+s*(su*1.3*ex[1]+sv*ey[1]+2*ez[1]),
              c[2]+s*(su*1.3*ex[2]+sv*ey[2]+2*ez[2])]);
  }
  return pts;
}
function polyline(arr, css, width){
  ctx.strokeStyle=css; ctx.lineWidth=width; ctx.beginPath();
  let pen=false;
  for (const p of arr){
    if (proj(p,a)) { pen ? ctx.lineTo(a[0],a[1]) : ctx.moveTo(a[0],a[1]);
                     pen=true; }
    else pen=false;
  }
  ctx.stroke();
}
function draw(){
  computeBasis();
  ctx.fillStyle='#121218'; ctx.fillRect(0,0,W,H);
  const t=id=>document.getElementById(id).checked;
  if (t('tPts')){
    ctx.fillStyle='#8a8a94';
    for (const p of SCENE.points)
      if (proj(p,a)) ctx.fillRect(a[0],a[1],a[2]>rad*3?1:2,a[2]>rad*3?1:2);
  }
  if (t('tEdg')){
    const showMarg=t('tMarg');
    for (const [i,j,ty,mg] of SCENE.edges){
      if (mg && !showMarg) continue;
      if (proj(SCENE.kf_centers[i],a) && proj(SCENE.kf_centers[j],b)){
        const c=COLORS[ty]||[150,150,150];
        ctx.strokeStyle = mg ? `rgba(${c[0]},${c[1]},${c[2]},0.35)`
                             : `rgb(${c[0]},${c[1]},${c[2]})`;
        ctx.lineWidth = ty===SCENE.edge_types.APPEARANCE ? 2 : 1;
        ctx.beginPath(); ctx.moveTo(a[0],a[1]); ctx.lineTo(b[0],b[1]);
        ctx.stroke();
      }
    }
  }
  if (t('tGt') && SCENE.gt.length>1) polyline(SCENE.gt,'#5a5a5a',2);
  if (t('tTraj') && SCENE.traj.length>1) polyline(SCENE.traj,'#fad23c',2);
  if (t('tKf')){
    for (let i=0;i<SCENE.kf_centers.length;i++){
      const hot = i===SCENE.actkey;
      ctx.strokeStyle = hot ? '#ff5a5a' : '#f0f0ff';
      ctx.lineWidth = hot ? 2 : 1;
      const f=frustum(i);
      ctx.beginPath();
      for (let k=1;k<=4;k++){
        if (proj(f[0],a)&&proj(f[k],b)){
          ctx.moveTo(a[0],a[1]); ctx.lineTo(b[0],b[1]);}
        const k2=k===4?1:k+1;
        if (proj(f[k],a)&&proj(f[k2],b)){
          ctx.moveTo(a[0],a[1]); ctx.lineTo(b[0],b[1]);}
      }
      ctx.stroke();
    }
  }
  document.getElementById('stat').textContent =
    `yaw ${view.yaw.toFixed(2)} pitch ${view.pitch.toFixed(2)} ` +
    `dist ${view.dist.toFixed(2)} m  target [${view.tgt.map(
      v=>v.toFixed(2)).join(', ')}]`;
}
function resize(){
  W=cvs.width=innerWidth*devicePixelRatio; H=cvs.height=innerHeight*devicePixelRatio;
  cvs.style.width=innerWidth+'px'; cvs.style.height=innerHeight+'px';
  draw();
}
addEventListener('resize',resize);

// --- interaction -----------------------------------------------------------
let drag=null;
cvs.addEventListener('contextmenu',e=>e.preventDefault());
cvs.addEventListener('mousedown',e=>{
  drag={x:e.clientX,y:e.clientY,pan:e.shiftKey||e.button===2};
  cvs.style.cursor='grabbing';});
addEventListener('mouseup',()=>{drag=null;cvs.style.cursor='grab';saveView();});
addEventListener('mousemove',e=>{
  if(!drag) return;
  const dx=e.clientX-drag.x, dy=e.clientY-drag.y;
  drag.x=e.clientX; drag.y=e.clientY;
  if (drag.pan){
    computeBasis();
    const s=view.dist/view.fl*devicePixelRatio;
    for(let i=0;i<3;i++)
      view.tgt[i]+= -dx*s*basis.right[i] + dy*s*basis.up[i];
  } else {
    view.yaw += dx*0.008;
    view.pitch = Math.max(-1.5,Math.min(1.5,view.pitch+dy*0.008));
  }
  draw();});
cvs.addEventListener('wheel',e=>{
  e.preventDefault();
  view.dist*=Math.exp(e.deltaY*0.001);
  view.dist=Math.max(rad*0.05,Math.min(rad*50,view.dist));
  draw(); saveView();},{passive:false});
cvs.addEventListener('dblclick',()=>{
  view=JSON.parse(JSON.stringify(DEF)); draw(); saveView();});
for (const el of document.querySelectorAll('#hud input'))
  el.addEventListener('change',draw);

document.getElementById('nPts').textContent=SCENE.points.length;
document.getElementById('nKf').textContent=SCENE.kf_centers.length;
document.getElementById('nEdg').textContent=SCENE.edges.length;
resize();
</script></body></html>
"""


def export_map_html(graph, trajectory=None, gt_poses=None, path="map3d.html",
                    actkey_id=None):
    """Write the interactive 3-D map viewer to `path` (atomically, so
    watch-mode browsers never see a torn file). Returns the scene dict."""
    scene = extract_scene(graph, trajectory, gt_poses, actkey_id)
    html = _HTML.replace("__SCENE_JSON__",
                         json.dumps(scene, separators=(",", ":")))
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(html)
    os.replace(tmp, path)
    return scene
