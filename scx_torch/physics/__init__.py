"""Rigid-body physics: the plane-layout fleet step (`planar`) and its parts."""
