from .updaters import Adam, Nesterovs, Sgd
