import sys

from phylonium_tpu_torch.serve.daemon import main

if __name__ == "__main__":
    sys.exit(main())
