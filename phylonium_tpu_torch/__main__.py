import os
import sys

from phylonium_tpu_torch.cli import main

if __name__ == "__main__":
    try:
        rc = main()
    except SystemExit as e:
        rc = int(e.code) if isinstance(e.code, int) else 1
    except KeyboardInterrupt:
        rc = 130  # conventional SIGINT exit, no traceback noise
    except BaseException:
        # Any crash must still leave through os._exit below: a normal
        # interpreter teardown with the prewarm, shipper or feeder thread
        # still inside CUDA can abort with "terminate called ..."
        # (SIGABRT), burying the actual traceback.
        import traceback

        traceback.print_exc()
        rc = 1
    # Perf invariant (tested): a run that counts on the host, or sends its
    # device work to the device server, must never import torch.
    if os.environ.get("PHYLONIUM_TPU_EXPECT_NO_TORCH") and "torch" in sys.modules:
        print(
            "PHYLONIUM_TPU_EXPECT_NO_TORCH: torch was imported on a run "
            "that expected none",
            file=sys.stderr,
        )
        rc = rc or 70
    # Hard exit: background threads (the device prewarm, the early query
    # shipper, the streamed feeder) may still hold the CUDA context, and
    # interpreter teardown does not wait for daemon threads. main() has
    # written and joined everything (cli.py); nothing below needs atexit.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
