"""The benchmark of pyfft_tpu_torch on the card: ``python3 benchmark/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`` from the root of
a checkout.  See ``harness.py`` for the layout."""
