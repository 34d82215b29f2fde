"""``python -m licensee_tpu_torch.analysis [--list-rules|FILE|DIR|
--changed REF|--stats|--no-cache|--cache-ab]``: the analyzer over the
port's package and its launcher; exits non-zero on any finding."""

import sys

from licensee_tpu_torch.analysis import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
