"""The port's command-line entry points (``gang_launch``, ``gang_worker``)."""
