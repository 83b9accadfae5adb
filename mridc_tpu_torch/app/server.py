"""Stdlib HTTP front-end for the run-builder app (counterpart of
``mridc_tpu/app/server.py``).

Serves a single-page UI (vanilla JS, no external assets: it works offline)
over :mod:`mridc_tpu_torch.app.core`. Endpoints:

  GET  /                    the page
  GET  /api/tasks           ["reconstruction", ...]
  GET  /api/models?task=    [{name, display, modes}, ...]
  GET  /api/config?task=&model=&mode=   {fields: [[dotkey, yaml-value], ...]}
  POST /api/export          {task, model, mode, overrides, export_dir, name}
                            -> {path, command}  (schema-validated)
  POST /api/run             {task, model, mode, overrides, export_dir}
                            -> {path, pid, log, command}
  GET  /api/log?path=&tail= tail of a run log

Replaces the reference's Streamlit page (reference: mridc/app/run.py,
launched by app/launch.py:29 ``streamlit run``); the export/run flow matches
run.py:2799-2833.
"""

from __future__ import annotations

import json
import shlex
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Dict
from urllib.parse import parse_qs, urlparse

from mridc_tpu_torch.app import core
from mridc_tpu_torch.train.schemas import ConfigValidationError

__all__ = ["make_server", "serve"]

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>mridc_tpu_torch run builder</title>
<style>
 body{font-family:system-ui,sans-serif;margin:2rem;max-width:1100px}
 h1{font-size:1.3rem} .row{margin:.4rem 0}
 label{display:inline-block;min-width:260px;font-family:monospace;font-size:.85rem}
 input,select{font-family:monospace;font-size:.85rem;min-width:280px}
 #fields{margin-top:1rem}
 fieldset{margin:.6rem 0;border:1px solid #ccc;columns:2;column-gap:2rem}
 legend{font-weight:600}
 details{break-inside:avoid;margin:.3rem 0}
 summary{cursor:pointer;font-size:.85rem;color:#555}
 .field{break-inside:avoid;margin:.15rem 0}
 button{margin:.5rem .5rem .5rem 0;padding:.4rem 1rem}
 pre{background:#f4f4f4;padding:.6rem;overflow:auto}
 .err{color:#b00020;white-space:pre-wrap}
</style></head><body>
<h1>mridc_tpu_torch run builder</h1>
<div class="row">
 <label>Task</label><select id="task"></select>
 <label style="min-width:80px">Model</label><select id="model"></select>
 <label style="min-width:80px">Mode</label><select id="mode"><option>train</option><option>run</option></select>
</div>
<div class="row"><label>Export directory</label><input id="export_dir" value="./app_runs"></div>
<div id="fields"></div>
<button onclick="doExport()">Export configuration</button>
<button onclick="doRun()">Export &amp; run</button>
<div id="out"></div>
<script>
const $=id=>document.getElementById(id);
let defaults={};
async function j(u,opt){const r=await fetch(u,opt);const d=await r.json();if(!r.ok)throw d;return d}
async function loadTasks(){const t=await j('/api/tasks');$('task').innerHTML=t.map(x=>`<option>${x}</option>`).join('');await loadModels()}
async function loadModels(){const m=await j('/api/models?task='+$('task').value);$('model').innerHTML=m.map(x=>`<option value="${x.name}">${x.display}</option>`).join('');await loadFields()}
const esc=s=>String(s).replace(/&/g,'&amp;').replace(/</g,'&lt;').replace(/"/g,'&quot;');
function widget(f){
 const k=esc(f.key), v=esc(f.text??'');
 if(f.type==='bool'){
  const sel=['true','false'].map(x=>`<option ${String(f.text)===x?'selected':''}>${x}</option>`).join('');
  return `<select data-key="${k}" data-opt="${f.optional?1:''}"><option value="" ${f.text===''?'selected':''}>unset</option>${sel}</select>`}
 if(f.type==='choice'){
  const opts=(f.choices||[]).map(c=>`<option ${String(f.text)===String(c)?'selected':''}>${esc(c)}</option>`).join('');
  const unset=f.choices&&f.choices.includes(f.text)?'':'selected';
  return `<select data-key="${k}" data-opt="${f.optional?1:''}"><option value="" ${unset}>unset</option>${opts}</select>`}
 const t=f.type==='number'?' inputmode="decimal"':'';
 return `<input data-key="${k}" data-opt="${f.optional?1:''}" value="${v}"${t}>`}
async function loadFields(){
 const d=await j(`/api/form?task=${$('task').value}&model=${$('model').value}&mode=${$('mode').value}`);
 defaults={};
 $('fields').innerHTML=d.groups.map(g=>{
  const base=g.fields.filter(f=>!f.optional), extra=g.fields.filter(f=>f.optional);
  g.fields.forEach(f=>{defaults[f.key]=String(f.text??'')});
  const row=f=>`<div class="field"><label title="${esc(f.key)} (${f.type})">${esc(f.key)}</label>${widget(f)}</div>`;
  const extras=extra.length?`<details><summary>${extra.length} more ${g.title.toLowerCase()} options</summary>${extra.map(row).join('')}</details>`:'';
  return `<fieldset><legend>${esc(g.title)}</legend>${base.map(row).join('')}${extras}</fieldset>`}).join('')}
function overrides(){const o={};document.querySelectorAll('#fields input,#fields select').forEach(i=>{
 const cur=i.value, base=defaults[i.dataset.key];
 if(i.dataset.opt){ if(cur!=='') o[i.dataset.key]=cur }
 else if(cur!==base) o[i.dataset.key]=cur});return o}
async function post(url){
 $('out').innerHTML='...';
 try{const d=await j(url,{method:'POST',headers:{'content-type':'application/json'},
  body:JSON.stringify({task:$('task').value,model:$('model').value,mode:$('mode').value,
   export_dir:$('export_dir').value,overrides:overrides()})});
  $('out').innerHTML=`<pre>${JSON.stringify(d,null,2)}</pre>`}
 catch(e){$('out').innerHTML=`<div class="err">${e.error||JSON.stringify(e)}</div>`}}
const doExport=()=>post('/api/export'); const doRun=()=>post('/api/run');
$('task').onchange=loadModels; $('model').onchange=loadFields; $('mode').onchange=loadFields;
loadTasks();
</script></body></html>"""


_LAUNCHED_LOGS: set = set()  # /api/log may only serve these


def _field_text(v) -> str:
    """Render a config leaf for an HTML text input. Strings/None pass
    through verbatim; containers render as JSON (flow-style YAML)."""
    if v is None:
        return ""
    if isinstance(v, str):
        return v
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    return json.dumps(v)


def _parse_overrides(raw: Dict[str, Any]) -> Dict[str, Any]:
    """Form values arrive as text; give them YAML semantics (like dotlist
    overrides, train/config.py parse_value)."""
    from mridc_tpu_torch.train.config import parse_value

    out = {}
    for k, v in (raw or {}).items():
        out[k] = parse_value(v) if isinstance(v, str) else v
    return out


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _send(self, code: int, payload, content_type="application/json"):
        body = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self) -> Dict[str, Any]:
        length = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(length) or b"{}")

    def do_GET(self):
        url = urlparse(self.path)
        q = {k: v[0] for k, v in parse_qs(url.query).items()}
        try:
            if url.path == "/":
                return self._send(200, _PAGE.encode(), "text/html; charset=utf-8")
            if url.path == "/api/tasks":
                return self._send(200, core.list_tasks())
            if url.path == "/api/models":
                return self._send(200, core.list_models(q["task"]))
            if url.path == "/api/config":
                cfg = core.load_defaults(q["task"], q["model"], q.get("mode", "train"))
                fields = [[k, _field_text(v)] for k, v in core.flatten_config(cfg)]
                return self._send(200, {"fields": fields})
            if url.path == "/api/form":
                from mridc_tpu_torch.app.forms import form_spec

                spec = form_spec(q["task"], q["model"], q.get("mode", "train"))
                for group in spec["groups"]:
                    for f in group["fields"]:
                        f["text"] = _field_text(f["default"])
                return self._send(200, spec)
            if url.path == "/api/log":
                tail = int(q.get("tail", 4000))
                path = str(Path(q["path"]).resolve())
                # only logs of runs this server launched (no arbitrary reads)
                if path not in _LAUNCHED_LOGS:
                    return self._send(403, {"error": "unknown log path (not launched by this app)"})
                text = Path(path).read_text(errors="replace")[-tail:]
                return self._send(200, {"log": text})
            return self._send(404, {"error": f"unknown path {url.path}"})
        except (KeyError, FileNotFoundError) as e:
            return self._send(400, {"error": str(e)})
        except Exception as e:  # pragma: no cover - defensive
            return self._send(500, {"error": f"{type(e).__name__}: {e}"})

    def do_POST(self):
        url = urlparse(self.path)
        try:
            req = self._body()
            if url.path in ("/api/export", "/api/run"):
                cfg = core.build_config(
                    req["task"], req["model"], req.get("mode", "train"), _parse_overrides(req.get("overrides"))
                )
                path = core.export_config(cfg, req.get("export_dir", "./app_runs"), req.get("name"))
                resp = {"path": str(path), "command": shlex.join(core.run_command(str(path)))}
                if url.path == "/api/run":
                    proc, log = core.launch_run(str(path))
                    _LAUNCHED_LOGS.add(str(log.resolve()))
                    resp.update(pid=proc.pid, log=str(log))
                return self._send(200, resp)
            return self._send(404, {"error": f"unknown path {url.path}"})
        except ConfigValidationError as e:
            return self._send(400, {"error": str(e)})
        except (KeyError, ValueError) as e:
            return self._send(400, {"error": f"{type(e).__name__}: {e}"})
        except Exception as e:  # pragma: no cover - defensive
            return self._send(500, {"error": f"{type(e).__name__}: {e}"})


def make_server(host: str = "127.0.0.1", port: int = 0) -> ThreadingHTTPServer:
    """Build (without starting) the HTTP server; port 0 picks a free port."""
    return ThreadingHTTPServer((host, port), _Handler)


def serve(host: str = "127.0.0.1", port: int = 8501):
    """Run the app server (blocking). Port defaults to Streamlit's 8501 so
    reference users' muscle memory keeps working."""
    httpd = make_server(host, port)
    actual = httpd.server_address[1]
    print(f"mridc_tpu_torch app: http://{host}:{actual}")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


def serve_in_thread(host: str = "127.0.0.1", port: int = 0):
    """Start the server on a daemon thread; returns (server, base_url)."""
    httpd = make_server(host, port)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, f"http://{host}:{httpd.server_address[1]}"
