"""Query plane: typed addresses, the planner and the device executor."""
