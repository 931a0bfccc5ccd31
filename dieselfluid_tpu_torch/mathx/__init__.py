"""Small rigid-transform math for the camera: quaternions and 4x4 matrices."""
