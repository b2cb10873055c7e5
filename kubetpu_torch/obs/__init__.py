"""The port of ``kubetpu.obs`` that the serving path and its wire need: the
metric registry with its Prometheus text (``registry``), the bounded event
log (``events``) and the tracer whose context rides the wire headers
(``trace``). The exporter, the SLO engine, the profiler and ``federate``
are not ported yet."""
