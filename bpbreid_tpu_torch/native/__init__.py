"""The port's host C++ components (``rank.cpp``: the CMC / mAP ranker)."""
