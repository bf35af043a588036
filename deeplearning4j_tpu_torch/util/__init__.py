from .convert import (graph_state_from_numpy, updater_state_from_numpy,
                      word2vec_state_from_numpy)
