"""Output sinks: NMEA socket broadcast, serial port, stdout.

Mirrors the reference's sink surface:
 - Unix-socket broadcast of each NMEA sentence to up to 20 connected
   clients (ipc.c; the GUI and any monitor consume this),
 - 4800-baud 8N1 raw serial NMEA with CRLF (serial.c),
 - stdout message lines (protodec printf path).
"""

from __future__ import annotations

import os
import socket
import sys
import threading
from typing import List, Optional

MAX_CLIENT_SOCKETS = 20            # ipc.h:27
DEFAULT_SOCKET_PATH = "/tmp/gnuais.socket"


class NmeaSocketServer:
    """Accept-thread + mutex-guarded broadcast, like gnuais_ipc_*
    (ipc.c:44-134).  Sentences are written bare (no CRLF), leading '!'
    included."""

    def __init__(self, path: str = DEFAULT_SOCKET_PATH):
        self.path = path
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass
        self._srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._srv.bind(path)
        self._srv.listen(8)
        self._clients: List[socket.socket] = []
        self._lock = threading.Lock()
        self._die = False
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._die:
            try:
                c, _ = self._srv.accept()
            except OSError:
                return
            with self._lock:
                if len(self._clients) < MAX_CLIENT_SOCKETS:
                    self._clients.append(c)
                else:
                    c.close()

    def write(self, sentence: str) -> None:
        data = sentence.encode("ascii")
        with self._lock:
            dead = []
            for c in self._clients:
                try:
                    c.sendall(data)
                except OSError:
                    dead.append(c)
            for c in dead:
                self._clients.remove(c)
                c.close()

    def close(self) -> None:
        self._die = True
        try:
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._srv.close()
        with self._lock:
            for c in self._clients:
                c.close()
            self._clients.clear()
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass


class SerialSink:
    """Raw 4800 8N1 serial NMEA output (serial.c:53-122).  Works on any
    tty path; falls back to plain writes for regular files/FIFOs so it
    is testable without hardware."""

    def __init__(self, port: str):
        self.fd = os.open(port, os.O_RDWR | os.O_NOCTTY | os.O_NONBLOCK)
        try:
            import termios
            attrs = termios.tcgetattr(self.fd)
            # cfmakeraw equivalent + 4800 8N1
            attrs[0] = 0                       # iflag
            attrs[1] = 0                       # oflag
            attrs[2] = (termios.CS8 | termios.CREAD | termios.CLOCAL)
            attrs[3] = 0                       # lflag
            attrs[4] = termios.B4800           # ispeed
            attrs[5] = termios.B4800           # ospeed
            termios.tcsetattr(self.fd, termios.TCSANOW, attrs)
        except Exception:
            pass  # not a tty: fine for tests
        self._lock = threading.Lock()

    def write(self, sentence: str) -> None:
        # serial gets "!...\r\n" (protodec.c:883-885)
        with self._lock:
            try:
                os.write(self.fd, (sentence + "\r\n").encode("ascii"))
            except BlockingIOError:
                pass

    def close(self) -> None:
        os.close(self.fd)


class StdoutSink:
    def __init__(self, stream=None):
        self.stream = stream or sys.stdout

    def write_line(self, line: str) -> None:
        self.stream.write(line + "\n")
        self.stream.flush()
