"""The port of ``kubetpu.api`` that the wire needs: leveled logging
(``utils``)."""
