from .convert import (fasttext_state_from_numpy, glove_state_from_numpy,
                      graph_state_from_numpy, multilayer_state_from_numpy,
                      samediff_state_from_numpy, updater_state_from_numpy,
                      word2vec_state_from_numpy)
