"""The benchmark's plain reference of the tracker (``tracker.py``)."""
