"""The device server: a resident process that builds and counts panels
for the CLI runs that ask for it (``PHYLONIUM_TPU_DEVD=1``).

The port of the JAX package's ``phylonium_tpu/serve/``. One daemon holds
a device's CUDA context, the loaded kernel library and a content cache
of the 2-bit query codes it was sent, and builds each run's pileup rows
(the pileup-build kernel) and counts its panel (the pair-count kernel)
there; the CLI's streamed and low-memory feeders talk to it over a unix
socket, and the CLI process itself never touches CUDA. The JAX server
exists because its TPU charges every fresh process a first-execution
cost; a card's context and kernel load cost a fresh process well under a
second, hidden under the index by the device prewarm, so the port's
server is off unless asked for. A run of several ranks never takes it.
Every failure on this route fails the run: nothing is retried in process
or on the host.

Layout: wire.py (the JAX package's framing, copied), daemon.py (the
server; ``python -m phylonium_tpu_torch.serve --device cuda|cpu``),
client.py (the connect-or-spawn client of the shipper and the feeder).
"""
