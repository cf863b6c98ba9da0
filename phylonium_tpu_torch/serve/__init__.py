"""The device server: a resident process that builds and counts panels
for the CLI runs on a card (by default the streamed and low-memory
routes of a single-process run; ``PHYLONIUM_TPU_DEVD=0`` keeps them in
process, ``=1`` takes the server on the CPU too).

The port of the JAX package's ``phylonium_tpu/serve/``. One daemon holds
a device's CUDA context, the loaded kernel library and a content cache
of the 2-bit query codes it was sent, and builds each run's pileup rows
(the pileup-build kernel) and counts its panel (the pair-count kernel)
there; the CLI's streamed and low-memory feeders talk to it over a unix
socket, and the CLI process itself never imports torch or touches
CUDA (client.py imports numpy only). The JAX server exists because its
TPU charges every fresh process a first-execution cost; on a card the
cost a resident process spares each run is torch's import and the CUDA
context, seconds that an in-process run waits for. A run of several
ranks never takes it by default, and ``=1`` there is an error.
Every failure on this route fails the run: nothing is retried in process
or on the host.

Layout: wire.py (the JAX package's framing, copied), daemon.py (the
server; ``python -m phylonium_tpu_torch.serve --device cuda|cpu``),
client.py (the connect-or-spawn client of the shipper and the feeder).
"""
