"""The loops that drive a cell: `loops/<name>.py` holds `run(cell)`, found
by the `loop` key of the cell's traffic mix."""
