"""Interactive editor / viewer: the reference's Swing UI (VulkanApp) as a
browser app over a threaded HTTP server.

The port of ``raytracer_tpu/apps/viewer.py``, with the same routes and
page: object list with add / remove, per-object position, uniform scale,
colour presets and custom RGB, material (Matte 0.0, Metal 1.0, Fuzzy
Metal 2.0, Emissive 3.0, ``VulkanApp.java:483-488``), the sky checkbox
and exposure slider -5..+5, WASD/QE camera keys with the reference step
vectors, FPS and sample readout; accumulation pauses while a rebuild is
in flight and resets on camera, scene and sky events. Every edit is a
device rebuild (``RenderEngine`` -> ``DeviceSceneBuilder``).

    python -m raytracer_tpu_torch.apps.viewer [--port 8000] [--width 640]
        [--scene scene.json] [--assets DIR] [--device cuda|cpu]

Renders on the card unless ``--device cpu``. Without ``--scene`` it
opens the reference default scene, each mesh resolved through
``utils.assets`` (``--assets`` / ``$RAYTPU_ASSETS``) or its procedural
fallback (``presets.reference_default_scene``).
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import os
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from raytracer_tpu_torch.core.camera import default_camera
from raytracer_tpu_torch.core.types import RenderConfig
from raytracer_tpu_torch.engine.loop import RenderEngine
from raytracer_tpu_torch.scene.scene import ModelInstance, Scene
from raytracer_tpu_torch.utils.log import get_logger

_log = get_logger("ui")

COLOR_PRESETS = {  # reference VulkanApp.java:475-481
    "Grey": (0.5, 0.5, 0.5), "White": (1.0, 1.0, 1.0),
    "Red": (1.0, 0.0, 0.0), "Green": (0.0, 1.0, 0.0),
    "Blue": (0.0, 0.0, 1.0),
}


class ViewerApp:
    """Single-writer owner of camera / scene / settings state."""

    def __init__(self, cfg: RenderConfig, scene: Scene,
                 ladder_frames: int = 8, device="cuda"):
        self.cfg = cfg
        self.scene = scene
        self.device = device
        self.camera = default_camera(cfg.width, cfg.height)
        self.sky_enabled = True
        self.exposure = 0.0
        # Resolution ladder: upscaled low-resolution frames while the
        # camera moves or right after an edit, full resolution when still.
        self.engine = RenderEngine(cfg, ladder_frames=ladder_frames,
                                   device=device)
        self._lock = threading.RLock()
        self._last_frame = None
        self._running = False
        self._ticker = None
        self._event_t = None  # perf_counter of the latest user action

    # --- lifecycle -----------------------------------------------------------

    def start(self):
        self._running = True
        self.engine.start()
        self.engine.on_scene_swapped = self._on_scene_swapped
        self.engine.rebuild_scene_async(self.scene)
        self._ticker = threading.Thread(target=self._tick_loop, name="UI",
                                        daemon=True)
        self._ticker.start()

    def stop(self, timeout: float = 5.0):
        self._running = False
        if self._ticker is not None:
            self._ticker.join(timeout)
        self.engine.stop(timeout)

    def _tick_loop(self):
        """The 16 ms Swing-timer analogue (VulkanApp.java:171,194-235);
        the accumulation counter advances once per rendered frame, not
        per tick, so slow frames still weight every sample right."""
        last_rendered = -1
        while self._running:
            with self._lock:
                self._refresh_frame()
                frame = self._last_frame
                if (frame is not None and frame.frame_number != last_rendered
                        and not self.engine.build_in_progress):
                    last_rendered = frame.frame_number
                    self.camera.increment_frame_count()
                self.engine.submit_camera_update(self._uniforms())
            time.sleep(0.016)

    def _refresh_frame(self):
        frame = self.engine.latest_frame()
        if frame is not None:
            self._last_frame = frame

    def _uniforms(self):
        uni = self.camera.uniforms(sky_enabled=self.sky_enabled,
                                   exposure=self.exposure,
                                   device=self.device)
        # Latency probe: the stamp of the latest user action (key, sky,
        # edit); the render thread tags the first frame after it changes.
        uni.event_t = self._event_t
        return uni

    def _on_scene_swapped(self):
        with self._lock:
            self.camera.reset_accumulation()

    # --- edits (each is an event: accumulation resets) -----------------------

    def key(self, k: str):
        with self._lock:
            self._event_t = time.perf_counter()
            self.camera.move(k)  # includes reset_accumulation
            # Submit now rather than at the next tick (the reference also
            # submits inside the key action, VulkanApp.java:747-750).
            self.engine.submit_camera_update(self._uniforms())

    def set_sky(self, enabled: bool):
        with self._lock:
            self._event_t = time.perf_counter()
            self.sky_enabled = bool(enabled)
            self.camera.reset_accumulation()

    def set_exposure(self, stops: float):
        with self._lock:  # tonemap only: no accumulation reset
            self.exposure = max(-5.0, min(5.0, float(stops)))

    def add_instance(self, data: dict):
        inst = ModelInstance(
            model_path=data["model_path"],
            display_name=data.get("display_name", ""),
            position=tuple(data.get("position", (0, 0, 0))),
            scale=tuple(data.get("scale", (1, 1, 1))),
            color=tuple(data.get("color", (0.8, 0.8, 0.8))),
            material_type=float(data.get("material_type", 0.0)))
        with self._lock:
            self.scene.add_instance(inst)
        self._rebuild()

    def update_instance(self, index: int, data: dict):
        with self._lock:
            instances = self.scene.get_instances()
            old = instances[index]
            instances[index] = dataclasses.replace(
                old,
                position=tuple(data.get("position", old.position)),
                scale=tuple(data.get("scale", old.scale)),
                color=tuple(data.get("color", old.color)),
                material_type=float(
                    data.get("material_type", old.material_type)))
            self.scene.clear()
            for inst in instances:
                self.scene.add_instance(inst)
        self._rebuild()

    def remove_instance(self, index: int):
        with self._lock:
            self.scene.remove_at(index)
        self._rebuild()

    def save_scene(self, path: str):
        self.scene.save_json(path)

    def load_scene(self, path: str):
        loaded = Scene.load_json(path)
        with self._lock:
            self.scene.clear()
            for inst in loaded.get_instances():
                self.scene.add_instance(inst)
        self._rebuild()

    def _rebuild(self):
        """Start the device rebuild of the current scene (skipped while
        another is in flight, as the reference's SRT does)."""
        with self._lock:
            self._event_t = time.perf_counter()
        self.engine.rebuild_scene_async(self.scene)

    # --- frame / state for HTTP ---------------------------------------------

    def frame_png(self) -> bytes:
        with self._lock:
            self._refresh_frame()
            frame = self._last_frame
        if frame is None:
            return b""
        try:
            from PIL import Image
        except ImportError:
            from raytracer_tpu_torch.utils.png import write_png

            fd, path = tempfile.mkstemp(suffix=".png")
            os.close(fd)
            try:
                write_png(path, frame.pixels)
                with open(path, "rb") as f:
                    return f.read()
            finally:
                os.unlink(path)
        buf = io.BytesIO()
        Image.fromarray(frame.pixels).save(buf, "JPEG", quality=90)
        return buf.getvalue()

    def state(self) -> dict:
        with self._lock:
            self._refresh_frame()
            frame = self._last_frame
            latency = self.engine.last_input_latency_ms
            return {
                "instances": [i.to_json()
                              for i in self.scene.get_instances()],
                "camera": {
                    "origin": list(self.camera.origin),
                    "look_at": list(self.camera.look_at),
                    "frame_count": self.camera.frame_count,
                },
                "sky_enabled": self.sky_enabled,
                "exposure": self.exposure,
                "building": self.engine.build_in_progress,
                # FPS / Mrays from the engine's rolling FrameCounter,
                # per-stage wall times from its StageTimer.
                "stats": None if frame is None else {
                    "frame": frame.frame_number,
                    "samples": frame.samples,
                    "render_ms": round(frame.render_ms, 1),
                    "fps": round(self.engine.meter.fps, 2),
                    "mrays": round(self.engine.meter.mrays_per_s, 2),
                    "preview": frame.preview,
                    "input_latency_ms": (None if latency is None
                                         else round(latency, 1)),
                },
                "stages": self.engine.profiler.summary(),
                "color_presets": COLOR_PRESETS,
                "materials": {"Matte (Lambertian)": 0.0,
                              "Metal (Shiny)": 1.0,
                              "Metal (Fuzzy)": 2.0,
                              "Emissive (Light)": 3.0},
            }


PAGE = """<!DOCTYPE html>
<html><head><title>raytracer_tpu_torch viewer</title><style>
body{font-family:sans-serif;margin:0;display:flex;background:#222;color:#ddd}
#view{flex:1;padding:10px}#panel{width:320px;padding:10px;background:#2b2b2b;
overflow-y:auto;height:100vh}img{max-width:100%;image-rendering:pixelated}
input,select,button{margin:2px;background:#444;color:#ddd;border:1px solid
#666}h3{margin:8px 0 4px}#objlist div{padding:2px;cursor:pointer}
#objlist .sel{background:#446}label{font-size:12px}</style></head><body>
<div id=view><img id=frame><div id=stats></div>
<p>Move: W/A/S/D forward/left/back/right, Q/E up/down (click the image
first)</p></div>
<div id=panel>
<h3>Objects</h3><div id=objlist></div>
<button onclick=removeSel()>Remove</button>
<h3>Add model</h3>
<input id=addpath placeholder=path/to/model.obj size=28>
<button onclick=addModel()>Add</button>
<h3>Selected object</h3>
<label>Pos</label><br>
<input id=px size=5><input id=py size=5><input id=pz size=5><br>
<label>Scale</label> <input id=sc size=6><br>
<label>Color</label> <select id=cpreset></select>
<input id=cr size=4><input id=cg size=4><input id=cb size=4><br>
<label>Material</label> <select id=mat></select><br>
<button onclick=applySel()>Apply</button>
<h3>Global settings</h3>
<label><input type=checkbox id=sky checked onchange=setSky()> Enable sky
light</label><br>
<label>Exposure <span id=expv>0.0</span></label><br>
<input type=range id=exp min=-5 max=5 step=0.1 value=0 oninput=setExp()>
<h3>Scene</h3>
<input id=scenepath value=scene.json size=20>
<button onclick="sceneIO('save')">Save</button>
<button onclick="sceneIO('load')">Load</button>
</div>
<script>
let sel=0,state=null;
const mats={"Matte (Lambertian)":0,"Metal (Shiny)":1,"Metal (Fuzzy)":2,
"Emissive (Light)":3};
function api(p,body){return fetch(p,{method:'POST',
body:JSON.stringify(body||{})}).then(r=>r.json())}
function refresh(){fetch('/api/state').then(r=>r.json()).then(s=>{
 state=s;const ol=document.getElementById('objlist');ol.innerHTML='';
 s.instances.forEach((o,i)=>{const d=document.createElement('div');
  d.textContent=o.display_name+(i==sel?' *':'');
  if(i==sel)d.className='sel';d.onclick=()=>{sel=i;fillSel();refresh()};
  ol.appendChild(d)});
 const st=s.stats;document.getElementById('stats').textContent=st?
  `frame ${st.frame} | ${st.fps} FPS | ${st.render_ms} ms | samples `+
  `${st.samples} | ${st.mrays} Mrays/s`+(s.building?' | rebuilding...':'')
  :'waiting for first frame...';})}
function fillSel(){if(!state||!state.instances[sel])return;
 const o=state.instances[sel];px.value=o.position[0];py.value=o.position[1];
 pz.value=o.position[2];sc.value=o.scale[0];cr.value=o.color[0];
 cg.value=o.color[1];cb.value=o.color[2];mat.value=o.material_type}
function applySel(){api('/api/instance/'+sel+'/update',{
 position:[+px.value,+py.value,+pz.value],
 scale:[+sc.value,+sc.value,+sc.value],
 color:[+cr.value,+cg.value,+cb.value],
 material_type:+mat.value}).then(refresh)}
function removeSel(){api('/api/instance/'+sel+'/remove').then(()=>{sel=0;
 refresh()})}
function addModel(){api('/api/instance/add',{model_path:addpath.value})
 .then(refresh)}
function setSky(){api('/api/settings',{sky:sky.checked})}
function setExp(){expv.textContent=exp.value;
 api('/api/settings',{exposure:+exp.value})}
function sceneIO(op){api('/api/scene/'+op,{path:scenepath.value})
 .then(refresh)}
document.addEventListener('keydown',e=>{
 const k=e.key.toUpperCase();
 if('WASDQE'.includes(k)&&document.activeElement.tagName!='INPUT')
  api('/api/key',{key:k})});
const matsel=document.getElementById('mat');
Object.entries(mats).forEach(([n,v])=>{const o=document.createElement(
 'option');o.text=n;o.value=v;matsel.add(o)});
const cp=document.getElementById('cpreset');
['Grey','White','Red','Green','Blue'].forEach(n=>{const o=
 document.createElement('option');o.text=n;cp.add(o)});
cp.onchange=()=>{const c={Grey:[.5,.5,.5],White:[1,1,1],Red:[1,0,0],
 Green:[0,1,0],Blue:[0,0,1]}[cp.value];cr.value=c[0];cg.value=c[1];
 cb.value=c[2]};
setInterval(()=>{document.getElementById('frame').src=
 '/frame.jpg?t='+Date.now()},100);
setInterval(refresh,1000);refresh();
</script></body></html>"""

def make_handler(app: ViewerApp):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/" or self.path.startswith("/index"):
                self._send(200, PAGE.encode(), "text/html")
            elif self.path.startswith("/frame.jpg"):
                self._send(200, app.frame_png(), "image/jpeg")
            elif self.path.startswith("/api/state"):
                self._send(200, json.dumps(app.state()).encode())
            else:
                self._send(404, b"{}")

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                data = json.loads(self.rfile.read(n) or b"{}")
                path = self.path
                if path == "/api/key":
                    app.key(data["key"])
                elif path == "/api/settings":
                    if "sky" in data:
                        app.set_sky(data["sky"])
                    if "exposure" in data:
                        app.set_exposure(data["exposure"])
                elif path == "/api/instance/add":
                    app.add_instance(data)
                elif path.startswith("/api/instance/"):
                    parts = path.split("/")
                    idx = int(parts[3])
                    if parts[4] == "update":
                        app.update_instance(idx, data)
                    elif parts[4] == "remove":
                        app.remove_instance(idx)
                    else:
                        return self._send(404, b"{}")
                elif path == "/api/scene/save":
                    app.save_scene(data["path"])
                elif path == "/api/scene/load":
                    app.load_scene(data["path"])
                else:
                    return self._send(404, b"{}")
                self._send(200, b'{"ok": true}')
            except Exception as e:  # surface errors like the Swing dialogs
                _log.exception("api error")
                self._send(500, json.dumps({"error": str(e)}).encode())

    return Handler


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="raytracer_tpu_torch.apps.viewer")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address; 0.0.0.0 exposes the unauthenticated "
                        "edit API on the network (opt-in)")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--spp", type=int, default=1)
    p.add_argument("--kernel", choices=("packet", "wavefront"),
                   default="packet")
    p.add_argument("--scene", help="scene JSON to open")
    p.add_argument("--assets", help="asset search dir override")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="render device (cuda raises without a card)")
    p.add_argument("--ladder", type=int, default=8,
                   help="preview (quarter-area) frames after each camera / "
                        "scene event before full resolution; 0 disables")
    args = p.parse_args(argv)
    if args.assets:
        os.environ["RAYTPU_ASSETS"] = args.assets
    from raytracer_tpu_torch.scene.presets import reference_default_scene

    cfg = RenderConfig(width=args.width, height=args.height,
                       samples_per_pixel=args.spp, kernel=args.kernel)
    scene = (Scene.load_json(args.scene) if args.scene
             else reference_default_scene())
    app = ViewerApp(cfg, scene, ladder_frames=args.ladder,
                    device=args.device)
    app.start()
    server = ThreadingHTTPServer((args.host, args.port), make_handler(app))
    print(f"viewer at http://{args.host}:{server.server_address[1]}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        app.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
