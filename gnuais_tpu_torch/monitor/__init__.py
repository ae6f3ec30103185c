"""Live ship monitor: the gnuaisgui-equivalent NMEA consumer.

The reference ships a GTK/OpenStreetMap viewer (src/gui/) that connects
to the receiver's Unix socket, reassembles multipart !AIVDM sentences,
re-decodes payloads for types 1-5 and maintains a bounded ship table
(gui.c:332-452, 97-230, 298-329).  This package provides the same
consumer surface headless: a sentence-stream client, the multipart
reassembler + payload decoder, the bounded ship table, and a terminal
renderer (curses/plain) in place of the map widget.
"""

from gnuais_tpu_torch.monitor.ships import AivdmAssembler, Ship, ShipTable  # noqa: F401
