"""The port of ``kubetpu.obs`` that the serving path needs: the metric
registry with its Prometheus text (``registry``) and the bounded event log
(``events``). The tracer, the exporter, the SLO engine and the profiler
are not ported yet."""
