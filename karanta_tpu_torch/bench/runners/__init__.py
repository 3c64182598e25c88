"""Bench methods of ``bench/convert.py`` (the port's copy of
``karanta_tpu/bench/runners``)."""
