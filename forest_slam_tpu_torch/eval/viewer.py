"""Interactive 3D trajectory and map viewer in one self-contained HTML file
(port of eval/viewer.py; json and HTML only).

The reference's live surface is RViz, subscribed to the SLAM node's pose
and cloud topics. A batch run has no ROS graph, so ``write_viewer_html``
embeds the estimated and ground-truth trajectories and the (downsampled)
map cloud into one HTML file with a dependency-free WebGL orbit viewer:
open it in a browser, with no server and no network. ``cli.py view`` writes
it, and ``mono``, ``stereo`` and ``slam`` with ``--viewer-out``.

Controls: drag = orbit, shift/right-drag = pan, wheel = zoom,
double-click = reset. A panel lists the layers (click to toggle) and each
trajectory's length.
"""

from __future__ import annotations

import json
import os

import numpy as np

# categorical layer colors (dark-background friendly)
_COLORS = [
    (0.31, 0.69, 1.00),  # azure — primary estimate
    (1.00, 0.62, 0.25),  # orange — secondary estimate
    (0.55, 0.95, 0.55),  # green
    (0.95, 0.55, 0.95),  # magenta
    (1.00, 0.90, 0.40),  # yellow
]
_GT_COLOR = (0.75, 0.78, 0.82)  # neutral grey for ground truth


def _traj_positions(traj) -> np.ndarray:
    """Accept a Trajectory (io/tum.py) or a raw (N, 3) / (N, 4, 4) array or CPU tensor."""
    if hasattr(traj, "positions"):
        return np.asarray(traj.positions, np.float32)
    a = np.asarray(traj, np.float32)
    if a.ndim == 3 and a.shape[-2:] == (4, 4):
        return a[:, :3, 3]
    if a.ndim == 2 and a.shape[1] == 3:
        return a
    raise ValueError(f"cannot interpret trajectory of shape {a.shape}")


def write_viewer_html(
    path: str,
    trajectories: dict[str, "np.ndarray"],
    points: np.ndarray | None = None,
    point_colors: np.ndarray | None = None,
    max_points: int = 400_000,
    title: str = "forest-slam viewer",
    refresh_seconds: float | None = None,
) -> None:
    """Write a standalone interactive viewer to ``path``.

    ``trajectories``: name -> Trajectory / (N,3) positions / (N,4,4) poses.
    A name equal to "ground truth" (or starting with "gt") renders grey.
    ``points``: optional (P, 3) map cloud; ``point_colors`` optional
    (P, 3) float [0,1] or uint8 [0,255]. Clouds above ``max_points`` are
    subsampled with a fixed stride so the file stays loadable.

    ``refresh_seconds``: embed a meta-refresh so an open browser reloads
    the file on that interval — the follow-mode (live-RViz-equivalent)
    surface: a writer regenerating this file during a run makes the open
    page show the trajectory grown so far (``run_stereo_vo_streaming``'s
    ``on_chunk`` under ``cli.py stereo --viewer-follow``).
    """
    layers = []
    ci = 0
    for name, traj in trajectories.items():
        pos = _traj_positions(traj)
        grey = name.lower().startswith("gt") or name.lower().startswith(
            "ground"
        )
        color = _GT_COLOR if grey else _COLORS[ci % len(_COLORS)]
        if not grey:
            ci += 1
        n = len(pos)
        length = float(
            np.linalg.norm(np.diff(pos, axis=0), axis=1).sum()
        ) if n > 1 else 0.0
        layers.append(
            {
                "name": name,
                "kind": "line",
                "color": list(color),
                "stats": f"{n} poses, {length:.1f} m",
                "data": np.round(pos, 4).ravel().tolist(),
            }
        )

    if points is not None and len(points):
        pts = np.asarray(points, np.float32)
        if len(pts) > max_points:
            stride = int(np.ceil(len(pts) / max_points))
            pts = pts[::stride]
            if point_colors is not None:
                point_colors = np.asarray(point_colors)[::stride]
        if point_colors is not None:
            cols = np.asarray(point_colors, np.float32)
            if cols.max() > 1.5:  # uint8-style
                cols = cols / 255.0
        else:
            # height-coded: map y (up is -y in camera/world convention here)
            # to a blue->warm ramp for depth legibility
            y = pts[:, 1]
            lo, hi = float(np.min(y)), float(np.max(y))
            tnorm = (y - lo) / (hi - lo + 1e-9)
            cols = np.stack(
                [0.25 + 0.7 * tnorm, 0.45 + 0.2 * (1 - tnorm), 0.9 - 0.6 * tnorm],
                axis=1,
            )
        layers.append(
            {
                "name": "map",
                "kind": "points",
                "color": None,
                "stats": f"{len(pts)} points",
                "data": np.round(pts, 4).ravel().tolist(),
                "colors": np.round(np.clip(cols, 0, 1), 3).ravel().tolist(),
            }
        )

    payload = json.dumps({"title": title, "layers": layers})
    html = _TEMPLATE.replace("__TITLE__", title).replace(
        '"__PAYLOAD__"', payload
    )
    if refresh_seconds is not None:
        html = html.replace(
            '<meta charset="utf-8">',
            '<meta charset="utf-8">'
            f'<meta http-equiv="refresh" content="{refresh_seconds:g}">',
        )
    # atomic replace: a follow-mode reader must never see a half-written file
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(html)
    os.replace(tmp, path)


_TEMPLATE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 html,body{margin:0;height:100%;background:#14171c;color:#cfd6e0;
   font:12px/1.5 system-ui,sans-serif;overflow:hidden}
 canvas{display:block;width:100vw;height:100vh}
 #hud{position:fixed;top:10px;left:10px;background:rgba(16,19,24,.85);
   border:1px solid #2a3038;border-radius:8px;padding:10px 14px;
   max-width:300px}
 #hud h1{font-size:13px;margin:0 0 6px;color:#e8edf4}
 .layer{display:flex;align-items:center;gap:8px;margin:3px 0;cursor:pointer}
 .sw{width:12px;height:12px;border-radius:3px;flex:none}
 .stats{color:#8b94a3;margin-left:auto;padding-left:10px}
 .off{opacity:.35}
 #help{position:fixed;bottom:10px;left:10px;color:#717a89}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud"><h1>__TITLE__</h1><div id="layers"></div></div>
<div id="help">drag orbit &middot; shift-drag pan &middot; wheel zoom &middot; dblclick reset</div>
<script>
const PAYLOAD = "__PAYLOAD__";
const canvas = document.getElementById('c');
const gl = canvas.getContext('webgl', {antialias: true});
if (!gl) document.body.innerHTML = '<p style="padding:2em">WebGL unavailable.</p>';

const VS = `attribute vec3 p; attribute vec3 col; uniform mat4 mvp;
uniform float psize; varying vec3 vc;
void main(){ gl_Position = mvp*vec4(p,1.0); gl_PointSize = psize; vc = col; }`;
const FS = `precision mediump float; varying vec3 vc;
void main(){ gl_FragColor = vec4(vc,1.0); }`;
function shader(t,s){const h=gl.createShader(t);gl.shaderSource(h,s);
 gl.compileShader(h);return h}
const prog = gl.createProgram();
gl.attachShader(prog, shader(gl.VERTEX_SHADER, VS));
gl.attachShader(prog, shader(gl.FRAGMENT_SHADER, FS));
gl.linkProgram(prog); gl.useProgram(prog);
const locP = gl.getAttribLocation(prog,'p');
const locC = gl.getAttribLocation(prog,'col');
const locMVP = gl.getUniformLocation(prog,'mvp');
const locPS = gl.getUniformLocation(prog,'psize');

// --- build GPU buffers per layer ---
const layers = PAYLOAD.layers.map(L => {
  const pos = new Float32Array(L.data);
  const n = pos.length/3;
  let cols;
  if (L.kind === 'points' && L.colors) cols = new Float32Array(L.colors);
  else { cols = new Float32Array(pos.length);
    for (let i=0;i<n;i++){cols[3*i]=L.color[0];cols[3*i+1]=L.color[1];cols[3*i+2]=L.color[2];} }
  const pb=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,pb);
  gl.bufferData(gl.ARRAY_BUFFER,pos,gl.STATIC_DRAW);
  const cb=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,cb);
  gl.bufferData(gl.ARRAY_BUFFER,cols,gl.STATIC_DRAW);
  return {meta:L, n, pb, cb, on:true};
});

// --- scene bounds -> initial camera ---
let lo=[1e9,1e9,1e9], hi=[-1e9,-1e9,-1e9];
for (const L of layers){const d=L.meta.data;
 for(let i=0;i<d.length;i+=3)for(let k=0;k<3;k++){
  lo[k]=Math.min(lo[k],d[i+k]);hi[k]=Math.max(hi[k],d[i+k]);}}
const center0=[(lo[0]+hi[0])/2,(lo[1]+hi[1])/2,(lo[2]+hi[2])/2];
const radius0=Math.max(1e-3,Math.hypot(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2]))*0.7;
let cam = {yaw:-0.7, pitch:0.45, dist:radius0*2.2, center:center0.slice()};
function resetCam(){cam={yaw:-0.7,pitch:0.45,dist:radius0*2.2,center:center0.slice()}}

// --- minimal mat4 ---
function perspective(fov,asp,near,far){const f=1/Math.tan(fov/2),
 nf=1/(near-far);return [f/asp,0,0,0, 0,f,0,0, 0,0,(far+near)*nf,-1,
 0,0,2*far*near*nf,0]}
function mul(a,b){const o=new Array(16).fill(0);
 for(let r=0;r<4;r++)for(let c=0;c<4;c++)for(let k=0;k<4;k++)
  o[c*4+r]+=a[k*4+r]*b[c*4+k];return o}
function lookMVP(w,h){
 const cy=Math.cos(cam.yaw),sy=Math.sin(cam.yaw);
 const cp=Math.cos(cam.pitch),sp=Math.sin(cam.pitch);
 const eye=[cam.center[0]+cam.dist*cp*sy, cam.center[1]-cam.dist*sp,
            cam.center[2]-cam.dist*cp*cy];
 const f=norm3(sub3(cam.center,eye));
 const r=norm3(cross3(f,[0,-1,0]));
 const u=cross3(r,f);
 const view=[r[0],u[0],-f[0],0, r[1],u[1],-f[1],0, r[2],u[2],-f[2],0,
  -dot3(r,eye),-dot3(u,eye),dot3(f,eye),1];
 return mul(perspective(0.9,w/h,radius0*0.01,radius0*40),view);}
function sub3(a,b){return[a[0]-b[0],a[1]-b[1],a[2]-b[2]]}
function dot3(a,b){return a[0]*b[0]+a[1]*b[1]+a[2]*b[2]}
function cross3(a,b){return[a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],
 a[0]*b[1]-a[1]*b[0]]}
function norm3(a){const l=Math.hypot(a[0],a[1],a[2])||1;
 return[a[0]/l,a[1]/l,a[2]/l]}

function draw(){
 const dpr=window.devicePixelRatio||1;
 const w=canvas.clientWidth*dpr,h=canvas.clientHeight*dpr;
 if(canvas.width!==w||canvas.height!==h){canvas.width=w;canvas.height=h}
 gl.viewport(0,0,w,h);
 gl.clearColor(0.078,0.09,0.11,1);gl.enable(gl.DEPTH_TEST);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 const mvp=lookMVP(w,h);gl.uniformMatrix4fv(locMVP,false,new Float32Array(mvp));
 for(const L of layers){ if(!L.on) continue;
  gl.bindBuffer(gl.ARRAY_BUFFER,L.pb);
  gl.enableVertexAttribArray(locP);gl.vertexAttribPointer(locP,3,gl.FLOAT,false,0,0);
  gl.bindBuffer(gl.ARRAY_BUFFER,L.cb);
  gl.enableVertexAttribArray(locC);gl.vertexAttribPointer(locC,3,gl.FLOAT,false,0,0);
  if(L.meta.kind==='points'){gl.uniform1f(locPS,2.0);gl.drawArrays(gl.POINTS,0,L.n)}
  else {gl.uniform1f(locPS,1.0);gl.drawArrays(gl.LINE_STRIP,0,L.n)}
 }
 requestAnimationFrame(draw);
}

// --- HUD ---
const hud=document.getElementById('layers');
layers.forEach((L,i)=>{
 const row=document.createElement('div');row.className='layer';
 const c = L.meta.kind==='points' ? [0.5,0.7,0.9] : L.meta.color;
 row.innerHTML=`<span class="sw" style="background:rgb(${c.map(x=>Math.round(x*255)).join(',')})"></span>
  <span>${L.meta.name}</span><span class="stats">${L.meta.stats}</span>`;
 row.onclick=()=>{L.on=!L.on;row.classList.toggle('off',!L.on)};
 hud.appendChild(row);
});

// --- interaction ---
let drag=null;
canvas.addEventListener('mousedown',e=>{drag={x:e.clientX,y:e.clientY,
 pan:e.shiftKey||e.button===2}});
window.addEventListener('mouseup',()=>drag=null);
window.addEventListener('mousemove',e=>{if(!drag)return;
 const dx=e.clientX-drag.x,dy=e.clientY-drag.y;drag.x=e.clientX;drag.y=e.clientY;
 if(drag.pan){const s=cam.dist*0.0015;
  const cy=Math.cos(cam.yaw),sy=Math.sin(cam.yaw);
  cam.center[0]-=dx*s*cy; cam.center[2]-=dx*s*sy; cam.center[1]-=dy*s;}
 else {cam.yaw+=dx*0.006; cam.pitch=Math.max(-1.5,Math.min(1.5,cam.pitch+dy*0.006));}});
canvas.addEventListener('wheel',e=>{e.preventDefault();
 cam.dist*=Math.exp(e.deltaY*0.0012);
 cam.dist=Math.max(radius0*0.05,Math.min(radius0*30,cam.dist))},{passive:false});
canvas.addEventListener('dblclick',resetCam);
canvas.addEventListener('contextmenu',e=>e.preventDefault());
draw();
</script></body></html>
"""
