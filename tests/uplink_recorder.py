"""A local stand-in for a JSON-AIS uplink, shared by the port's CLI tests
and ``chip_smoke.py``: an HTTP server on 127.0.0.1 that keeps the JSON
of every POST (the one field of the exporter's multipart form)."""

import http.server
import re
import threading


class UplinkRecorder:
    """Serves on an ephemeral port of 127.0.0.1 until ``close()``;
    ``url`` is the uplink's address, ``posts`` the JSON of each POST in
    the order received."""

    def __init__(self):
        posts = self.posts = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                # the form's one field: after its headers, before the
                # closing boundary
                posts.append(body.decode().split("\r\n\r\n", 1)[1]
                             .rsplit("\r\n--", 1)[0])
                self.send_response(200)
                self.end_headers()

            def log_message(self, *a):
                pass

        self.httpd = http.server.HTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}/jsonais"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def masked(blob: str) -> str:
    """A JSON-AIS blob with its wall clock times masked."""
    return re.sub(r'"\d{14}"', '"T"', blob)
