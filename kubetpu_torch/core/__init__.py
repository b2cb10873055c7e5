"""The port of ``kubetpu.core`` that the serving path needs: the latency
recorder (``metrics``)."""
