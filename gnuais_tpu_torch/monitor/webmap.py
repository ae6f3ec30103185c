"""Web map monitor: the gnuaisgui equivalent (gui.c:474-617,
osm-gps-map-ais.c:440-475) as a local HTTP view.

Fully self-contained (no CDN assets): the page implements a Web
Mercator slippy map in plain canvas — drag to pan, wheel to zoom,
ship triangles rotated to heading/course with name labels, track
trails, and a click-to-inspect panel (the cairo ship overlay's
feature set, osm-gps-map-ais.c:440-475).  Map tiles are served from a
LOCAL tile cache directory (``~/.cache/gnuais-tpu/tiles/z/x/y.png`` by
default) exactly like the reference's osm-gps-map widget renders its
on-disk tile cache; missing tiles draw as graticule sea, so the view
works with zero network access.  With ``tile_fetch=True`` the server
fetches missing tiles from the OSM tile service once and caches them
(the widget's online mode).

    gnuais-tpu --monitor --map [--port 8787]
"""

from __future__ import annotations

import json
import os
import socket as socket_mod
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

from gnuais_tpu_torch.monitor.ships import AivdmAssembler, ShipTable

DEFAULT_TILE_DIR = os.path.join(
    os.environ.get("XDG_CACHE_HOME",
                   os.path.join(os.path.expanduser("~"), ".cache")),
    "gnuais-tpu", "tiles")

PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>gnuais-tpu ships</title>
<style>
 body{margin:0;font:13px sans-serif;background:#06131f;overflow:hidden}
 #map{position:absolute;inset:0;cursor:grab}
 #hud{position:absolute;top:8px;right:8px;background:rgba(8,24,40,.85);
      color:#cde;padding:6px 10px;border-radius:4px}
 #info{position:absolute;left:8px;bottom:8px;background:rgba(8,24,40,.9);
      color:#cde;padding:8px 12px;border-radius:4px;display:none;
      max-width:320px}
 #zoomer{position:absolute;top:8px;left:8px}
 #zoomer button{width:28px;height:28px;font-size:16px}
</style></head><body>
<canvas id="map"></canvas>
<div id="hud">loading…</div><div id="info"></div>
<div id="zoomer"><button id="zin">+</button><button id="zout">&minus;</button></div>
<script>
// --- self-contained Web Mercator slippy map (no external assets) ----
const TILE=256, cv=document.getElementById('map'), ctx=cv.getContext('2d');
let z=5, cx=0.515, cy=0.295;      // map center in world [0,1) coords
let ships=[], trails={}, sel=null, tiles={};
function resize(){cv.width=innerWidth;cv.height=innerHeight;draw();}
addEventListener('resize',resize);
function w2px(wx,wy){ const s=TILE*Math.pow(2,z);
  return [cv.width/2+(wx-cx)*s, cv.height/2+(wy-cy)*s]; }
function px2w(px,py){ const s=TILE*Math.pow(2,z);
  return [cx+(px-cv.width/2)/s, cy+(py-cv.height/2)/s]; }
function ll2w(lat,lon){ const r=lat*Math.PI/180;
  return [(lon+180)/360,
          (1-Math.log(Math.tan(r)+1/Math.cos(r))/Math.PI)/2]; }
function tile(zz,x,y){ const k=zz+'/'+x+'/'+y;
  if(k in tiles) return tiles[k];
  tiles[k]=null;
  const im=new Image();
  im.onload=()=>{tiles[k]=im;draw();};
  im.onerror=()=>{tiles[k]=false;};
  im.src='/tiles/'+k+'.png';
  return null; }
function drawGrid(){ // graticule sea for missing tiles / tileless mode
  ctx.strokeStyle='rgba(110,160,200,.25)'; ctx.fillStyle='#0a2236';
  const step=Math.pow(2,Math.max(0,6-z))*5;   // degrees per line
  ctx.beginPath();
  for(let lat=-80;lat<=80;lat+=step){
    const [x0,y0]=w2px(...ll2w(lat,-180)), [x1,y1]=w2px(...ll2w(lat,180));
    ctx.moveTo(x0,y0); ctx.lineTo(x1,y1); }
  for(let lon=-180;lon<=180;lon+=step){
    const [x0,y0]=w2px(...ll2w(80,lon)), [x1,y1]=w2px(...ll2w(-80,lon));
    ctx.moveTo(x0,y0); ctx.lineTo(x1,y1); }
  ctx.stroke();
}
function drawTiles(){
  const n=Math.pow(2,z), s=TILE;
  const [wx0,wy0]=px2w(0,0), [wx1,wy1]=px2w(cv.width,cv.height);
  const tx0=Math.floor(wx0*n), tx1=Math.floor(wx1*n);
  const ty0=Math.max(0,Math.floor(wy0*n)), ty1=Math.min(n-1,Math.floor(wy1*n));
  for(let ty=ty0;ty<=ty1;ty++) for(let tx=tx0;tx<=tx1;tx++){
    const txw=((tx%n)+n)%n;
    const im=tile(z,txw,ty);
    const [px,py]=w2px(tx/n,ty/n), sc=s*Math.pow(2,z)* (1/n) /s;
    const sz=TILE*Math.pow(2,z)/n;
    if(im) ctx.drawImage(im,px,py,sz+0.5,sz+0.5);
  }
}
function shipPath(px,py,ang){
  ctx.save(); ctx.translate(px,py); ctx.rotate(ang*Math.PI/180);
  ctx.beginPath(); ctx.moveTo(0,-9); ctx.lineTo(6,7); ctx.lineTo(0,3);
  ctx.lineTo(-6,7); ctx.closePath(); ctx.restore();
}
function draw(){
  ctx.fillStyle='#06131f'; ctx.fillRect(0,0,cv.width,cv.height);
  drawGrid(); drawTiles();
  for(const s of ships){
    const tr=trails[s.mmsi]||[];
    if(tr.length>1){ ctx.strokeStyle='rgba(120,220,170,.5)';
      ctx.beginPath();
      tr.forEach((p,i)=>{const [px,py]=w2px(p[0],p[1]);
        i?ctx.lineTo(px,py):ctx.moveTo(px,py);});
      ctx.stroke(); }
    const [wx,wy]=ll2w(s.latitude,s.longitude);
    const [px,py]=w2px(wx,wy);
    const ang=(s.heading&&s.heading<360)?s.heading:(s.course||0);
    shipPath(px,py,ang);
    ctx.fillStyle=(sel===s.mmsi)?'#ff8c3a':'#ffcf40'; ctx.fill();
    ctx.strokeStyle='#06131f'; ctx.stroke();
    ctx.fillStyle='#9fc';
    ctx.fillText(s.name||s.mmsi,px+8,py+4);
  }
}
cv.addEventListener('mousedown',e=>{
  const sx=e.clientX, sy=e.clientY, ox=cx, oy=cy;
  cv.style.cursor='grabbing';
  let moved=false;
  function mm(ev){ const s=TILE*Math.pow(2,z);
    cx=ox-(ev.clientX-sx)/s; cy=oy-(ev.clientY-sy)/s;
    moved=moved||Math.abs(ev.clientX-sx)+Math.abs(ev.clientY-sy)>3;
    draw(); }
  function mu(ev){ removeEventListener('mousemove',mm);
    removeEventListener('mouseup',mu); cv.style.cursor='grab';
    if(!moved) pick(ev.clientX,ev.clientY); }
  addEventListener('mousemove',mm); addEventListener('mouseup',mu);
});
function pick(px,py){
  sel=null; let best=144;
  for(const s of ships){ const [wx,wy]=ll2w(s.latitude,s.longitude);
    const [qx,qy]=w2px(wx,wy), d=(qx-px)**2+(qy-py)**2;
    if(d<best){best=d;sel=s.mmsi;} }
  const el=document.getElementById('info');
  const s=ships.find(x=>x.mmsi===sel);
  if(s){ el.style.display='block';
    // name/destination arrive over RF / the NMEA socket and are
    // attacker-controllable — HTML-escape before innerHTML insertion
    const esc=t=>String(t).replace(/[&<>"']/g,
      c=>({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c]));
    el.innerHTML=`<b>${esc(s.name||'(unnamed)')} </b> MMSI ${s.mmsi}`+
      `<br>${s.latitude.toFixed(5)}, ${s.longitude.toFixed(5)}`+
      `<br>SOG ${s.speed} kn · COG ${s.course}&deg; · HDG ${s.heading}`+
      (s.destination?`<br>&rarr; ${esc(s.destination)}`:'')+
      `<br><small>type ${s.type} · seen ${new Date(
         s.last_seen*1000).toLocaleTimeString()}</small>`;
  } else el.style.display='none';
  draw();
}
function zoomAt(px,py,dz){
  const [wx,wy]=px2w(px,py);
  z=Math.max(2,Math.min(17,z+dz)); tiles={};
  const s=TILE*Math.pow(2,z);
  cx=wx-(px-cv.width/2)/s; cy=wy-(py-cv.height/2)/s; draw();
}
cv.addEventListener('wheel',e=>{e.preventDefault();
  zoomAt(e.clientX,e.clientY,e.deltaY<0?1:-1);});
document.getElementById('zin').onclick=()=>zoomAt(cv.width/2,cv.height/2,1);
document.getElementById('zout').onclick=()=>zoomAt(cv.width/2,cv.height/2,-1);
let centered=false;
async function tick(){
  try{
    const r=await fetch('/ships.json'); const d=await r.json();
    ships=d.ships;
    for(const s of ships){
      const w=ll2w(s.latitude,s.longitude);
      const tr=trails[s.mmsi]||(trails[s.mmsi]=[]);
      const last=tr[tr.length-1];
      if(!last||last[0]!==w[0]||last[1]!==w[1]){
        tr.push(w); if(tr.length>200) tr.shift(); }
    }
    if(!centered&&ships.length){
      [cx,cy]=ll2w(ships[0].latitude,ships[0].longitude);
      z=9; centered=true; }
    document.getElementById('hud').textContent=
      ships.length+' ships · z'+z+' · '+new Date().toLocaleTimeString();
    draw();
  }catch(e){ document.getElementById('hud').textContent='no data: '+e; }
  setTimeout(tick, 2000);
}
resize(); tick();
</script></body></html>
"""

# a 1x1 transparent PNG: the "no tile" response body (the client keeps
# its graticule sea visible underneath)
_EMPTY_PNG = bytes.fromhex(
    "89504e470d0a1a0a0000000d49484452000000010000000108060000001f15c489"
    "0000000a49444154789c63000100000500010d0a2db40000000049454e44ae4260"
    "82")


class WebMapServer:
    """HTTP view over a live ShipTable with a local tile cache.

    tile_dir: on-disk tile cache laid out ``z/x/y.png`` (the layout
    osm-gps-map and every slippy-map tool uses — point it at an
    existing cache to get real coastlines fully offline).
    tile_fetch: fetch missing tiles from the OSM tile service and cache
    them (requires network; off by default).
    """

    def __init__(self, table: ShipTable, port: int = 8787,
                 host: str = "127.0.0.1",
                 tile_dir: Optional[str] = None,
                 tile_fetch: bool = False):
        self.table = table
        self.tile_dir = Path(tile_dir or DEFAULT_TILE_DIR)
        self.tile_fetch = tile_fetch
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path.startswith("/ships.json"):
                    body = json.dumps(outer.snapshot()).encode()
                    ctype = "application/json"
                elif self.path.startswith("/tiles/"):
                    body, ok = outer.tile_bytes(self.path[len("/tiles/"):])
                    if not ok:
                        self.send_response(404)
                        self.end_headers()
                        return
                    ctype = "image/png"
                elif self.path == "/" or self.path.startswith("/index"):
                    body = PAGE.encode()
                    ctype = "text/html; charset=utf-8"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                if ctype == "image/png":
                    self.send_header("Cache-Control", "max-age=86400")
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)

    def tile_bytes(self, rel: str):
        """(png bytes, found) for a 'z/x/y.png' request path."""
        parts = rel.split("/")
        if len(parts) != 3 or not parts[2].endswith(".png"):
            return b"", False
        try:
            zz = int(parts[0])
            xx = int(parts[1])
            yy = int(parts[2][:-4])
        except ValueError:
            return b"", False
        p = self.tile_dir / str(zz) / str(xx) / f"{yy}.png"
        if p.exists():
            return p.read_bytes(), True
        if self.tile_fetch:
            try:
                import urllib.request
                req = urllib.request.Request(
                    f"https://tile.openstreetmap.org/{zz}/{xx}/{yy}.png",
                    headers={"User-Agent": "gnuais-tpu/0.1 map monitor"})
                with urllib.request.urlopen(req, timeout=10) as r:
                    data = r.read()
                p.parent.mkdir(parents=True, exist_ok=True)
                p.write_bytes(data)
                return data, True
            except Exception:
                pass
        return b"", False

    def snapshot(self) -> dict:
        ships = [dict(mmsi=s.mmsi, latitude=s.latitude,
                      longitude=s.longitude, heading=s.heading,
                      course=s.course, speed=s.speed, type=s.type,
                      name=s.name, destination=s.destination,
                      last_seen=s.last_seen)
                 for s in self.table.ships.values()]
        return {"ships": ships, "dropped": self.table.dropped}

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


def monitor_socket_with_map(path: str = "/tmp/gnuais.socket",
                            port: int = 8787,
                            duration: Optional[float] = None,
                            tile_dir: Optional[str] = None,
                            tile_fetch: bool = False) -> ShipTable:
    """gnuaisgui main-loop equivalent: consume the NMEA socket into the
    ship table and serve the map view."""
    table = ShipTable()
    asm = AivdmAssembler()
    srv = WebMapServer(table, port, tile_dir=tile_dir,
                       tile_fetch=tile_fetch)
    srv.start()
    print(f"map view: http://127.0.0.1:{srv.port}/", flush=True)
    s = socket_mod.socket(socket_mod.AF_UNIX, socket_mod.SOCK_STREAM)
    s.connect(path)
    s.settimeout(0.5)
    t0 = time.time()
    try:
        while duration is None or time.time() - t0 < duration:
            try:
                data = s.recv(4096)
            except socket_mod.timeout:
                continue
            if not data:
                break
            for bits in asm.feed(data):
                table.update_from_bits(bits)
    finally:
        s.close()
        srv.stop()
    return table
