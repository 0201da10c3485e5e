"""Live watch: a continuous HTTP view and operator control of a running server.

Counterpart of mujoco_ros_pkgs_tpu/server/watch.py. The reference's
operators watch and drive the GLFW viewer window (viewer.cpp RenderLoop
:2262-2383; Sync :1552-1871 syncs the window's edits of opt, qpos and ctrl
into the engine under the physics mutex). A server on a card is headless,
so both are HTTP:

- `/stream`: a multipart/x-mixed-replace stream of PNG frames (motion-PNG,
  shown by browsers as MJPEG is);
- `/frame.png`: one frame; `/`: the control page around the stream;
- `POST /api/<name>`: JSON endpoints onto the server's services (pause and
  run, step N, reset, speed, keyframe load and save, live ctrl and qpos,
  physics options, wrenches, picking and drag perturbation, model info,
  reload). The admin hash rides in the JSON body (`admin_hash`) and the
  services enforce it;
- `GET /api/stats`: the solver and real-time figures the page plots (the
  viewer's figtimer and figconstraint panels, viewer.h:267-271).

Frames and endpoints run on HTTP threads and take the server's lock as any
service does. Standard library only (http.server, utils/png.py).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

import numpy as np

from mujoco_ros_pkgs_tpu_torch.utils import png
from mujoco_ros_pkgs_tpu_torch.utils.log import get_logger

_log = get_logger("watch")

_PAGE = b"""<!doctype html>
<html><head><title>mujoco_ros_pkgs_tpu_torch live view</title>
<style>
 body{margin:0;background:#111;color:#ddd;font:13px system-ui;display:grid;
      grid-template-rows:auto 1fr;height:100vh}
 #bar{padding:6px;display:flex;gap:6px;align-items:center;background:#1b1b1b;
      flex-wrap:wrap}
 button{background:#333;color:#ddd;border:1px solid #555;border-radius:3px;
        padding:4px 10px;cursor:pointer}
 button:hover{background:#444}
 input{width:70px;background:#222;color:#ddd;border:1px solid #555}
 #stats{margin-left:auto;font-family:monospace;white-space:pre}
 #main{display:grid;grid-template-columns:1fr 280px;overflow:hidden}
 #view{display:grid;place-items:center;overflow:hidden}
 img{max-width:100%;max-height:100%;cursor:crosshair;user-select:none}
 #panel{overflow-y:auto;background:#181818;padding:8px;font-size:12px}
 #panel h4{margin:10px 0 4px}
 .sl{display:grid;grid-template-columns:90px 1fr 44px;gap:4px;
     align-items:center;margin:2px 0}
 .sl input[type=range]{width:100%}
 .sl span{font-family:monospace;overflow:hidden;text-overflow:ellipsis}
 #sel{color:#8cf;font-family:monospace}
</style></head>
<body>
<div id="bar">
 <button onclick="api('pause',{paused:true})">pause</button>
 <button onclick="api('pause',{paused:false})">run</button>
 <input id="nsteps" value="100"/>
 <button onclick="api('step',{n:+document.getElementById('nsteps').value})">step</button>
 <button onclick="api('reset',{})">reset</button>
 <input id="speed" value="1.0"/>
 <button onclick="api('speed',{factor:+document.getElementById('speed').value})">speed</button>
 <input id="key" value="0"/>
 <button onclick="api('keyframe',{action:'load',key:+document.getElementById('key').value})">load key</button>
 <button onclick="api('keyframe',{action:'save',key:+document.getElementById('key').value})">save key</button>
 <input id="hash" placeholder="admin hash"/>
 <span id="sel"></span>
 <span id="stats"></span>
</div>
<div id="main">
 <div id="view"><img id="im" src="/stream" draggable="false"/></div>
 <div id="panel">
  <h4>model</h4>
  <input type="file" id="mfile" style="width:100%" accept=".xml,.mjcf"/>
  <button style="width:100%;margin-top:4px" onclick="uploadModel()">
    upload + reload</button>
  <h4>controls</h4><div id="acts"></div>
  <h4>joints</h4><div id="jnts"></div>
  <h4>profiler</h4>
  <canvas id="prof_rt" width="264" height="70"></canvas>
  <canvas id="prof_solver" width="264" height="70"></canvas>
 </div>
</div>
<script>
async function api(name, body){
  body.admin_hash = document.getElementById('hash').value;
  const r = await fetch('/api/'+name, {method:'POST',
    headers:{'Content-Type':'application/json'}, body:JSON.stringify(body)});
  const j = await r.json();
  if(!j.success && name!='select') alert(name+': '+(j.message||'failed'));
  return j;
}
/* profiler figures (viewer.h:267-271 figtimer/figconstraint, as canvas
   time-series fed by /api/stats) */
const hist = [];                               // ring buffer of stats rows
function drawFig(id, series, colors){
  const c = document.getElementById(id), g = c.getContext('2d');
  g.fillStyle = '#141414'; g.fillRect(0, 0, c.width, c.height);
  g.font = '9px monospace';
  series.forEach(([label, vals], k) => {
    if(!vals.length) return;
    const mx = Math.max(...vals, 1e-9), mn = Math.min(...vals, 0);
    g.strokeStyle = colors[k]; g.beginPath();
    vals.forEach((v, i) => {
      const x = i * c.width / 120;
      const y = c.height - 10 - (v - mn) / (mx - mn || 1) * (c.height - 22);
      i ? g.lineTo(x, y) : g.moveTo(x, y);
    });
    g.stroke();
    g.fillStyle = colors[k];
    g.fillText(`${label}=${(+vals[vals.length-1]).toPrecision(3)}`,
               4 + k * 88, 9);
  });
}
function col(key){ return hist.map(h => +h[key] || 0); }
async function poll(){
  try{
    const r = await fetch('/api/stats'); const s = await r.json();
    document.getElementById('stats').textContent =
      `t=${(+s.sim_time).toFixed(2)}s rt=${(+s.measured_slowdown).toFixed(2)}x `+
      `ncon=${s.ncon_active} it=${s.solver_iterations_realized}`;
    hist.push(s); if(hist.length > 120) hist.shift();
    drawFig('prof_rt', [['rt', col('measured_slowdown')],
                        ['t', col('sim_time')]], ['#8cf', '#888']);
    drawFig('prof_solver', [['ncon', col('ncon_active')],
                            ['iters', col('solver_iterations_realized')]],
            ['#fc8', '#8f8']);
  }catch(e){}
  setTimeout(poll, 1000);
}
poll();

/* ---- widget panel (viewer.h joint/control slider sections) ---- */
function slider(parent, label, lo, hi, val, oninput){
  const row = document.createElement('div'); row.className='sl';
  const s = document.createElement('span'); s.textContent = label;
  const r = document.createElement('input'); r.type='range';
  r.min=lo; r.max=hi; r.step=(hi-lo)/200 || 0.01; r.value=val;
  const v = document.createElement('span'); v.textContent=(+val).toFixed(2);
  r.oninput = () => {v.textContent=(+r.value).toFixed(2); oninput(+r.value);};
  row.append(s, r, v); parent.append(row); return r;
}
let sliders = {a:[], j:[]};
async function buildPanel(){
  const mi = await api('minfo', {});
  if(!mi.success) return;
  const acts = document.getElementById('acts'); acts.innerHTML='';
  sliders.a = mi.actuators.map((a,i)=>{
    const [lo,hi] = a.limited ? a.ctrlrange : [-1,1];
    return slider(acts, a.name||('act'+i), lo, hi, mi.ctrl[i],
                  v=>api('ctrl',{index:i, value:v}));
  });
  const jn = document.getElementById('jnts'); jn.innerHTML='';
  sliders.j = [];
  mi.joints.forEach((j,i)=>{
    if(j.type!=2 && j.type!=3) return;        // slide=2 / hinge=3 only
    const [lo,hi] = j.limited ? j.range : [-3.14,3.14];
    sliders.j.push([j.qposadr,
      slider(jn, j.name||('jnt'+i), lo, hi, mi.qpos[j.qposadr],
             v=>api('qpos',{index:j.qposadr, value:v, zero_qvel:true}))]);
  });
}
async function refreshPanel(){
  try{
    const mi = await api('minfo', {});
    if(mi.success){
      sliders.a.forEach((s,i)=>{ if(document.activeElement!==s){
        s.value=mi.ctrl[i];
        s.nextElementSibling.textContent=(+mi.ctrl[i]).toFixed(2);}});
      sliders.j.forEach(([q,s])=>{ if(document.activeElement!==s){
        s.value=mi.qpos[q];
        s.nextElementSibling.textContent=(+mi.qpos[q]).toFixed(2);}});
    }
  }catch(e){}
  setTimeout(refreshPanel, 1500);
}
buildPanel(); setTimeout(refreshPanel, 1500);

async function uploadModel(){
  const f = document.getElementById('mfile').files[0];
  if(!f) return alert('pick a model file first');
  const text = await f.text();
  const r = await api('reload', {model:text});
  if(r.success) buildPanel();
}

/* ---- drag perturbation (viewer.cpp:1451-1480 mouse perturbation) ---- */
const im = document.getElementById('im');
let drag = null;
function pix(e){
  const b = im.getBoundingClientRect();
  return {x:(e.clientX-b.left)*im.naturalWidth/b.width,
          y:(e.clientY-b.top)*im.naturalHeight/b.height};
}
im.addEventListener('mousedown', async e => {
  const p = pix(e);
  const s = await api('select', p);
  if(s.success && s.body > 0){
    drag = {body:s.body_name, dist:s.dist, t:0};
    document.getElementById('sel').textContent = 'grab: '+s.body_name;
  } else {
    document.getElementById('sel').textContent = '';
  }
});
im.addEventListener('mousemove', e => {
  if(!drag) return;
  const now = Date.now();
  if(now - drag.t < 60) return;               // ~16 Hz updates
  drag.t = now;
  const p = pix(e);
  api('perturb', {body:drag.body, x:p.x, y:p.y, dist:drag.dist});
});
window.addEventListener('mouseup', () => {
  if(drag){ api('clear_perturb', {body:drag.body}); }
  drag = null;
  document.getElementById('sel').textContent = '';
});
</script>
</body></html>
"""

_BOUNDARY = "mrpframe"


class WatchServer:
    """Serve live PNG frames + JSON control endpoints over HTTP.

    frame_fn: () -> (H, W, 3) uint8 RGB array (called at most `fps` times/s;
    one render is shared by all connected clients via a tiny cache).
    control: optional dict name -> callable(body_dict) -> jsonable dict,
    exposed as POST /api/<name>. A "stats" entry is additionally exposed as
    GET /api/stats."""

    def __init__(self, frame_fn: Callable[[], np.ndarray], port: int = 0,
                 fps: float = 10.0, host: str = "127.0.0.1",
                 control: Optional[Dict[str, Callable]] = None):
        self._frame_fn = frame_fn
        self._fps = max(float(fps), 0.1)
        self._cache: Optional[bytes] = None
        self._cache_t = 0.0
        self._cache_lock = threading.Lock()
        self._control = dict(control or {})
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):   # route to the named logger
                _log.debug("http %s", fmt % args)

            def _json(self, obj, code=200):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_POST(self):
                try:
                    if not self.path.startswith("/api/"):
                        self.send_error(404)
                        return
                    name = self.path[len("/api/"):]
                    fn = outer._control.get(name)
                    if fn is None:
                        self._json({"success": False,
                                    "message": f"no endpoint '{name}'"}, 404)
                        return
                    n = int(self.headers.get("Content-Length", "0") or 0)
                    raw = self.rfile.read(n) if n else b"{}"
                    try:
                        body = json.loads(raw or b"{}")
                        if not isinstance(body, dict):
                            raise ValueError("body must be a JSON object")
                    except ValueError as exc:
                        self._json({"success": False,
                                    "message": f"bad JSON: {exc}"}, 400)
                        return
                    try:
                        self._json(fn(body))
                    except Exception as exc:   # endpoint bug != dead server
                        _log.error("api/%s failed: %s", name, exc)
                        self._json({"success": False, "message": str(exc)},
                                   500)
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def do_GET(self):
                try:
                    if self.path in ("/", "/index.html"):
                        self.send_response(200)
                        self.send_header("Content-Type", "text/html")
                        self.send_header("Content-Length", str(len(_PAGE)))
                        self.end_headers()
                        self.wfile.write(_PAGE)
                    elif (self.path == "/api/stats"
                          and "stats" in outer._control):
                        try:
                            self._json(outer._control["stats"]({}))
                        except Exception as exc:
                            self._json({"success": False,
                                        "message": str(exc)}, 500)
                    elif self.path == "/frame.png":
                        data = outer._encoded_frame()
                        self.send_response(200)
                        self.send_header("Content-Type", "image/png")
                        self.send_header("Content-Length", str(len(data)))
                        self.end_headers()
                        self.wfile.write(data)
                    elif self.path == "/stream":
                        self.send_response(200)
                        self.send_header(
                            "Content-Type",
                            f"multipart/x-mixed-replace; boundary={_BOUNDARY}")
                        self.end_headers()
                        period = 1.0 / outer._fps
                        while not outer._stop.is_set():
                            t0 = time.monotonic()
                            data = outer._encoded_frame()
                            self.wfile.write(
                                f"--{_BOUNDARY}\r\nContent-Type: image/png\r\n"
                                f"Content-Length: {len(data)}\r\n\r\n"
                                .encode())
                            self.wfile.write(data)
                            self.wfile.write(b"\r\n")
                            self.wfile.flush()
                            dt = period - (time.monotonic() - t0)
                            if dt > 0:
                                time.sleep(dt)
                    else:
                        self.send_error(404)
                except (BrokenPipeError, ConnectionResetError):
                    pass   # client went away mid-stream

        self._stop = threading.Event()
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        _log.info("live view at http://%s:%d/ (%.1f fps)", host, self.port,
                  self._fps)

    def _encoded_frame(self) -> bytes:
        """PNG-encode at most `fps` times/s; concurrent clients share frames."""
        now = time.monotonic()
        with self._cache_lock:
            if self._cache is not None and (now - self._cache_t) < 1.0 / self._fps:
                return self._cache
            frame = np.asarray(self._frame_fn(), dtype=np.uint8)
            self._cache = png.encode(frame)
            self._cache_t = now
            return self._cache

    def stop(self):
        self._stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()
