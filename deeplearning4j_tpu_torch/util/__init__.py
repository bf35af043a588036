from .convert import graph_state_from_numpy
