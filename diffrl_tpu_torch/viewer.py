"""Interactive in-browser simulation viewer, a standalone HTML file with no
dependencies (port of diffrl_tpu/viewer.py).

Scene geometry and a recorded trajectory are embedded as JSON next to a
small vanilla-JS software 3D renderer (orbit camera, playback timeline,
frame scrubbing), so any browser, one without network access included, can
inspect a rollout. The API is UsdRenderer's (render.py): construct with a
Model, call ``update(state, time)`` per frame, ``save()`` at the end. Y-up,
the engine's convention. Body transforms come from the port's ``eval_fk``.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from .render import body_transforms, host
from .sim.model import (
    GEO_BOX,
    GEO_CAPSULE,
    GEO_PLANE,
    GEO_SPHERE,
    Model,
    State,
)


def _f(x):
    return [round(float(v), 5) for v in host(x).reshape(-1)]


class HtmlViewer:
    """Records frames of a single-env simulation into a standalone HTML."""

    def __init__(self, model: Model, path: str, fps: float = 60.0,
                 particle_radius: float = 0.05, title: str = "diffrl_tpu"):
        self.model = model
        self.path = path
        self.fps = fps
        self.title = title
        self.particle_radius = particle_radius
        self._body_frames: List[list] = []   # [T][L][7]
        self._particle_frames: List[list] = []  # [T][P][3]
        self._lines: List[dict] = []         # named per-frame polylines
        self._times: List[float] = []

        self.shapes = []
        has_ground = False
        if model.shape_body is not None and np.asarray(model.shape_body).size:
            body = np.asarray(model.shape_body)
            gtype = np.asarray(model.shape_geo_type)
            scale = np.asarray(model.shape_geo_scale)
            X = np.asarray(model.shape_transform)
            for s in range(body.shape[0]):
                g = int(gtype[s])
                if g == GEO_PLANE:
                    has_ground = True
                    continue
                kind = {GEO_SPHERE: "sphere", GEO_BOX: "box",
                        GEO_CAPSULE: "capsule"}.get(g)
                if kind is None:
                    continue
                self.shapes.append(dict(
                    body=int(body[s]), kind=kind,
                    scale=_f(scale[s][:3]),
                    pos=_f(X[s][0:3]), quat=_f(X[s][3:7]),
                ))
        self.ground = has_ground or bool(getattr(model, "ground", False))

    # ------------------------------------------------------------ per-frame

    def update(self, state: State, time: float):
        self._times.append(float(time))
        if self.model.link_count:
            X_sc = body_transforms(self.model, state.joint_q)
            self._body_frames.append(
                [_f(X_sc[b]) for b in range(X_sc.shape[0])])
        if state.particle_q is not None:
            self._particle_frames.append(
                [_f(p) for p in host(state.particle_q)])

    def add_line_strip(self, vertices, name: str, time: float = 0.0):
        """Per-frame polyline (muscle paths etc.), like UsdRenderer's."""
        self._lines.append(dict(name=name, t=float(time),
                                points=[_f(v) for v in host(vertices)]))

    # ------------------------------------------------------------------ io

    def save(self) -> str:
        data = dict(
            title=self.title,
            fps=self.fps,
            ground=self.ground,
            shapes=self.shapes,
            particle_radius=self.particle_radius,
            bodies=self._body_frames,
            particles=self._particle_frames,
            lines=self._lines,
            times=self._times,
        )
        html = _HTML_TEMPLATE.replace(
            "/*__DATA__*/", "const DATA = " + json.dumps(data) + ";")
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        with open(self.path, "w") as f:
            f.write(html)
        return self.path


def export_html(model: Model, joint_q_frames, path: str,
                fps: float = 60.0,
                particle_q_frames: Optional[np.ndarray] = None,
                title: str = "diffrl_tpu") -> str:
    """One-call export: [T, C] joint trajectories -> interactive HTML."""
    v = HtmlViewer(model, path, fps=fps, title=title)
    q = host(joint_q_frames)
    for t in range(q.shape[0]):
        st = State(joint_q=q[t],
                   particle_q=(None if particle_q_frames is None
                               else particle_q_frames[t]))
        v.update(st, t / fps)
    return v.save()


_HTML_TEMPLATE = """<!doctype html>
<html><head><meta charset="utf-8"><title>diffrl_tpu viewer</title>
<style>
 body{margin:0;background:#14161a;color:#cfd3dc;font:13px system-ui}
 #hud{position:fixed;left:10px;top:8px;user-select:none}
 #bar{position:fixed;left:0;right:0;bottom:0;padding:8px 12px;
      background:#1d2026;display:flex;gap:10px;align-items:center}
 #scrub{flex:1}
 button{background:#2d323b;color:#cfd3dc;border:0;border-radius:4px;
        padding:4px 12px;cursor:pointer}
 canvas{display:block}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud"></div>
<div id="bar">
 <button id="play">pause</button>
 <input id="scrub" type="range" min="0" value="0" step="1">
 <span id="frame"></span>
</div>
<script>
/*__DATA__*/
const cv=document.getElementById('c'),ctx=cv.getContext('2d');
let W,H;function rs(){W=cv.width=innerWidth;H=cv.height=innerHeight-42}
rs();addEventListener('resize',rs);
const T=Math.max(DATA.bodies.length,DATA.particles.length,1);
let cam={yaw:0.7,pitch:0.35,dist:6,cx:0,cy:0.6,cz:0};
let frame=0,playing=true;
const scrub=document.getElementById('scrub');scrub.max=T-1;
// --- math ---
function qrot(q,v){ // q=[x,y,z,w]
 const[x,y,z,w]=q,[vx,vy,vz]=v;
 const tx=2*(y*vz-z*vy),ty=2*(z*vx-x*vz),tz=2*(x*vy-y*vx);
 return[vx+w*tx+y*tz-z*ty,vy+w*ty+z*tx-x*tz,vz+w*tz+x*ty-y*tx];
}
function xf(X,v){const p=qrot(X.slice(3,7),v);return[p[0]+X[0],p[1]+X[1],p[2]+X[2]];}
function proj(p){
 const sy=Math.sin(cam.yaw),cyw=Math.cos(cam.yaw);
 const sp=Math.sin(cam.pitch),cp=Math.cos(cam.pitch);
 let x=p[0]-cam.cx,y=p[1]-cam.cy,z=p[2]-cam.cz;
 let x1=cyw*x+sy*z,z1=-sy*x+cyw*z;
 let y1=cp*y-sp*z1,z2=sp*y+cp*z1+cam.dist;
 if(z2<0.05)return null;
 const f=0.9*Math.min(W,H)/z2;
 return[W/2+f*x1,H/2-f*y1,f];
}
function line(a,b,c,w){const A=proj(a),B=proj(b);if(!A||!B)return;
 ctx.strokeStyle=c;ctx.lineWidth=w||1;ctx.beginPath();
 ctx.moveTo(A[0],A[1]);ctx.lineTo(B[0],B[1]);ctx.stroke();}
function circle(p,r,c,fill){const P=proj(p);if(!P)return;
 ctx.beginPath();ctx.arc(P[0],P[1],Math.max(1,r*P[2]),0,7);
 if(fill){ctx.fillStyle=c;ctx.fill()}else{ctx.strokeStyle=c;ctx.stroke()}}
const BOX_E=[[0,1],[1,3],[3,2],[2,0],[4,5],[5,7],[7,6],[6,4],[0,4],[1,5],[2,6],[3,7]];
function drawBox(X,s,col){
 const cs=[];for(let i=0;i<8;i++)cs.push(xf(X,[(i&1?1:-1)*s[0],(i&2?1:-1)*s[1],(i&4?1:-1)*s[2]]));
 for(const[a,b]of BOX_E)line(cs[a],cs[b],col,1.5);
}
function compose(Xb,Xl){const q=Xb.slice(3,7),p=xf(Xb,Xl.slice(0,3));
 const[ax,ay,az,aw]=q,[bx,by,bz,bw]=Xl.slice(3,7);
 return[p[0],p[1],p[2],
  aw*bx+ax*bw+ay*bz-az*by, aw*by+ay*bw+az*bx-ax*bz,
  aw*bz+az*bw+ax*by-ay*bx, aw*bw-ax*bx-ay*by-az*bz];
}
function draw(){
 ctx.fillStyle='#14161a';ctx.fillRect(0,0,W,H);
 if(DATA.ground){for(let i=-10;i<=10;i++){
   line([i,0,-10],[i,0,10],'#262a31',1);line([-10,0,i],[10,0,i],'#262a31',1);}}
 line([0,0,0],[0.5,0,0],'#b5524f',2);line([0,0,0],[0,0.5,0],'#4f9e57',2);
 line([0,0,0],[0,0,0.5],'#4f6db5',2);
 const bodies=DATA.bodies[Math.min(frame,DATA.bodies.length-1)];
 if(bodies)for(const sh of DATA.shapes){
  const Xb=sh.body<0?[0,0,0,0,0,0,1]:bodies[sh.body];
  const X=compose(Xb,[...sh.pos,...sh.quat]);
  if(sh.kind==='sphere')circle(X.slice(0,3),sh.scale[0],'#e8a75d',false);
  else if(sh.kind==='box')drawBox(X,sh.scale,'#e8a75d');
  else if(sh.kind==='capsule'){
   const h=sh.scale[1],a=xf(X,[-h,0,0]),b=xf(X,[h,0,0]);
   line(a,b,'#e8a75d',2);circle(a,sh.scale[0],'#e8a75d',false);
   circle(b,sh.scale[0],'#e8a75d',false);}
 }
 const parts=DATA.particles[Math.min(frame,DATA.particles.length-1)];
 if(parts)for(const p of parts)circle(p,DATA.particle_radius,'#7fb3e8',true);
 for(const L of DATA.lines)if(Math.round(L.t*DATA.fps)===frame)
   for(let i=0;i+1<L.points.length;i++)line(L.points[i],L.points[i+1],'#c46a9e',2);
 document.getElementById('hud').textContent=
   DATA.title+'  |  drag: orbit, wheel: zoom';
 document.getElementById('frame').textContent=(frame+1)+' / '+T;
 scrub.value=frame;
}
let last=0;
function tick(ts){
 if(playing&&ts-last>1000/DATA.fps){frame=(frame+1)%T;last=ts}
 draw();requestAnimationFrame(tick);
}
requestAnimationFrame(tick);
// --- controls ---
let drag=null;
cv.addEventListener('mousedown',e=>drag=[e.clientX,e.clientY]);
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{if(!drag)return;
 cam.yaw+=(e.clientX-drag[0])*0.008;
 cam.pitch=Math.max(-1.4,Math.min(1.4,cam.pitch+(e.clientY-drag[1])*0.008));
 drag=[e.clientX,e.clientY];});
cv.addEventListener('wheel',e=>{cam.dist=Math.max(0.5,cam.dist*(1+e.deltaY*0.001))});
document.getElementById('play').onclick=function(){
 playing=!playing;this.textContent=playing?'pause':'play';};
scrub.oninput=function(){frame=+this.value;playing=false;
 document.getElementById('play').textContent='play';};
</script></body></html>
"""
