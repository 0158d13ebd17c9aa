"""The frozen yardstick of the rooflines and the MFU: published peaks,
the operations and bytes an operator's inputs need, and the model FLOPs of
a configuration counted on the reference."""
